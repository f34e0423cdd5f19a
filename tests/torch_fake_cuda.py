"""Fake CUDA tensors on a torch built without CUDA, for the dry run's tests.

``FakeTensorMode`` makes CUDA tensors without a card, but PyTorch's
Python indexing takes a device guard of the tensor's device, and a torch
built without CUDA registers none for it ("not linked with support for
cuda devices"). :func:`cuda_guard` lends the CUDA slot of c10's guard
registry the meta device's no-op guard for the length of a ``with`` and
empties the slot again after. The guard moves no data and opens no
device: a real CUDA tensor is still refused. A no-op where torch has
CUDA (there ``FakeTensorMode`` sets its own).
"""

import contextlib
import ctypes
import os

import torch

_CPU, _CUDA, _META = 0, 1, 14          # c10::DeviceType
_REGISTRY = "_ZN3c104impl26device_guard_impl_registryE"


@contextlib.contextmanager
def cuda_guard():
    if torch.backends.cuda.is_built():
        yield
        return
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libc10.so"))
    base = ctypes.addressof(ctypes.c_void_p.in_dll(lib, _REGISTRY))
    slots = (ctypes.c_void_p * (_META + 1)).from_address(base)
    # the registry as this torch lays it out: CPU's and meta's guards
    # set, CUDA's empty; anything else is refused before a write
    if not (slots[_CPU] and slots[_META]) or slots[_CUDA]:
        raise RuntimeError("c10's device guard registry is not laid out "
                           "as expected")
    slots[_CUDA] = slots[_META]
    try:
        yield
    finally:
        slots[_CUDA] = None
