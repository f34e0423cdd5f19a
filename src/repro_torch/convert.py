"""Carry a fitted dictionary over from the reference into the port.

``session_from_arrays`` takes the reference session's state as numpy
arrays, as a caller reads it from a ``repro.LassoSession``::

    arrays = {"X": np.asarray(sess.geometry.X),
              "sumsq": np.asarray(sess.geometry.sumsq),
              "eig_cache": {b: np.asarray(v)
                            for b, v in sess._eig_cache.items()}}
    port = session_from_arrays(arrays, device="cpu")

and returns a port session that adopts that geometry without a fit pass
(``fit_passes == 0``). Carrying the per-bucket Lipschitz eigenvectors
makes both packages' warm starts begin from the same vectors.
"""

from __future__ import annotations

from .core.engine import DictionaryGeometry
from .core.session import LassoSession, PathConfig, as_tensor, resolve_device


def session_from_arrays(arrays, *, config: PathConfig | None = None,
                        device=None) -> LassoSession:
    """A :class:`LassoSession` over ``arrays["X"]`` with the fitted
    ``arrays["sumsq"]`` (‖x_j‖²) and, optionally, ``arrays["eig_cache"]``
    (bucket size → eigenvector). ``device=None`` is the card."""
    cfg = config if config is not None else PathConfig()
    dev = resolve_device(device)
    X = as_tensor(arrays["X"], dev)
    if X.dim() != 2:
        raise ValueError(f"X must be (n, p), got shape {tuple(X.shape)}")
    sumsq = as_tensor(arrays["sumsq"], dev, X.dtype)
    if tuple(sumsq.shape) != (X.shape[1],):
        raise ValueError(f"sumsq must be ({X.shape[1]},), got "
                         f"{tuple(sumsq.shape)}")
    sess = LassoSession._new(X, cfg)
    geom = DictionaryGeometry(X, sess._default_backend, _sumsq=sumsq)
    sess._geometries[geom.backend.name] = geom
    for bucket, v in (arrays.get("eig_cache") or {}).items():
        sess._eig_cache[int(bucket)] = as_tensor(v, dev, X.dtype)
    return sess
