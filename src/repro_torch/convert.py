"""Carry a fitted dictionary over from the reference into the port.

``session_from_arrays`` takes the reference session's state as numpy
arrays, as a caller reads it from a ``repro.LassoSession``::

    arrays = {"X": np.asarray(sess.geometry.X),
              "sumsq": np.asarray(sess.geometry.sumsq),
              "eig_cache": {b: np.asarray(v)
                            for b, v in sess._eig_cache.items()}}
    port = session_from_arrays(arrays, device="cpu")

and returns a port session that adopts that geometry without a fit pass
(``fit_passes == 0``). A reference *group* session (``groups=m``) hands
over ``{"X": ..., "groups": m, "spec_norms": np.asarray(
sess.geometry.spec_norms)}`` instead of ``sumsq``. Carrying the
per-bucket Lipschitz eigenvectors makes both packages' warm starts begin
from the same vectors.
"""

from __future__ import annotations

from .core.engine import DictionaryGeometry, GroupDictionaryGeometry
from .core.session import (LassoSession, PathConfig, as_tensor,
                           resolve_device)


def session_from_arrays(arrays, *, config: PathConfig | None = None,
                        device=None) -> LassoSession:
    """A :class:`LassoSession` over ``arrays["X"]`` with the fitted
    ``arrays["sumsq"]`` (‖x_j‖²) — or, for ``arrays["groups"] = m > 1``,
    the fitted ``arrays["spec_norms"]`` (‖X_g‖₂) — and, optionally,
    ``arrays["eig_cache"]`` (bucket size → eigenvector). ``device=None``
    is the card."""
    cfg = config if config is not None else PathConfig()
    dev = resolve_device(device)
    X = as_tensor(arrays["X"], dev)
    if X.dim() != 2:
        raise ValueError(f"X must be (n, p), got shape {tuple(X.shape)}")
    m = int(arrays.get("groups") or 1)
    name, width = ("spec_norms", X.shape[1] // m) if m > 1 \
        else ("sumsq", X.shape[1])
    fitted = as_tensor(arrays[name], dev, X.dtype)
    if tuple(fitted.shape) != (width,):
        raise ValueError(f"{name} must be ({width},), got "
                         f"{tuple(fitted.shape)}")
    sess = LassoSession._new(X, cfg, m)
    if m > 1:
        geom = GroupDictionaryGeometry(X, m, sess._default_backend,
                                       _spec_norms=fitted)
    else:
        geom = DictionaryGeometry(X, sess._default_backend, _sumsq=fitted)
    sess._geometries[geom.backend.name] = geom
    for bucket, v in (arrays.get("eig_cache") or {}).items():
        sess._eig_cache[int(bucket)] = as_tensor(v, dev, X.dtype)
    return sess
