"""The ctypes bindings of the hand-written kernels against their C declarations.

The kernels build and run only on the card, but a wrapper that passes an
argument of the wrong width, or one too few, corrupts the call silently there;
these checks read ``csrc/*.cu`` and need neither ``nvcc`` nor a GPU.
"""

import ctypes
import re

import pytest

from blvm_tpu_torch.ops import cuda

_C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64, "float": ctypes.c_float}


def _c_entry_points():
    """``{name: [ctypes type of each parameter]}`` of every ``extern "C"`` function in ``csrc/*.cu``."""
    entries = {}
    for src in sorted(cuda.CSRC_DIR.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = [p.strip().rsplit(None, 1)[0] for p in params.split(",")]
            entries[name] = [ctypes.c_void_p if "*" in t else _C_TYPES[t] for t in types]
    return entries


def test_every_c_entry_point_is_bound():
    assert set(_c_entry_points()) == set(cuda._SIGNATURES)


@pytest.mark.parametrize("name", sorted(cuda._SIGNATURES))
def test_ctypes_signature_matches_the_c_declaration(name):
    assert cuda._SIGNATURES[name] == _c_entry_points()[name]


def test_every_launch_is_counted_under_its_kernel_name():
    """One counter per entry point, and every ``count_launch`` in the package names one."""
    assert set(cuda.launch_counts()) == {name.removeprefix("blvm_") for name in cuda._SIGNATURES}
    package = cuda.CSRC_DIR.parent
    counted = {m for path in package.rglob("*.py") for m in re.findall(r'count_launch\("(\w+)"\)', path.read_text())}
    assert counted == set(cuda.launch_counts())
