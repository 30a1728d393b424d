"""Drifted ctypes binding for abi_card.cu (parsed, never imported)."""
import ctypes


def build(lib):
    fn = lib.fixture_decode
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, i, i, i, p, p]  # ABI003: sigma bound as int
    fn.restype = f  # ABI005: the entry point returns int
    lib.fixture_occupancy.argtypes = [i, i]  # ABI002: one argument dropped
    lib.fixture_occupancy.restype = i
    lib.fixture_gone.argtypes = [p]  # ABI001: no such entry point
    return fn
