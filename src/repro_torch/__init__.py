"""PyTorch/CUDA port of the Lasso screening system (EDPP, NIPS 2013).

    from repro_torch import LassoSession
    sess = LassoSession.fit(X)          # on the GPU; device="cpu" for CPU
    res = sess.path(y).squeeze()
    bat = sess.path(Y)                  # Y (B, n): one PathResult, B queries
    shard = LassoSession.fit(X, mesh=mesh)   # X split by columns over a
                                             # torch.distributed DeviceMesh

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
# bf16 products accumulate in f32 without reduced-precision reductions,
# as the reference's preferred_element_type=float32 products do (the LM
# stack's matmuls, ``models/layers.dot``)
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from .core import (  # noqa: E402,F401
    LassoSession,
    PathConfig,
    PathResult,
    PathStepStats,
    ScreenSpec,
    SolveSpec,
    lambda_grid,
)
from .convert import session_from_arrays  # noqa: E402,F401
