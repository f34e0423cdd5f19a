"""PyTorch/CUDA port of the Lasso screening system (EDPP, NIPS 2013).

    from repro_torch import LassoSession
    sess = LassoSession.fit(X)          # on the GPU; device="cpu" for CPU
    res = sess.path(y).squeeze()

It mirrors ``repro`` (the JAX reference, which it never imports): the
screening and solver kernels are hand-written CUDA (``kernels/``), the
rest is PyTorch.
"""

import torch

# Full float32 matrix products: the duality-gap certificate at tol ≤ 1e-6
# cannot survive TF32's ~3 decimal digits in the solver's forward fit
# X @ z or the gap's X.T @ r, so TF32 stays off for cuBLAS and cuDNN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core import (  # noqa: E402,F401
    LassoSession,
    PathConfig,
    PathResult,
    ScreenSpec,
    SolveSpec,
    lambda_grid,
)
from .convert import session_from_arrays  # noqa: E402,F401
