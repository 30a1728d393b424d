"""Matched ctypes binding for abi_card.cu (parsed, never imported): the
wrapper modules' idioms, local aliases and a function alias."""
import ctypes


def build(lib):
    fn = lib.fixture_decode
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, i, i, f, p, p]
    fn.restype = i
    lib.fixture_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
    lib.fixture_occupancy.restype = i
    return fn
