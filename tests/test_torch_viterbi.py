"""The port's plain PyTorch Viterbi decode against the JAX package's.

Inputs are made with numpy from a seed and handed to both. The port's
scan repeats the JAX scan's float operations in its order, so on the CPU
its paths are equal and its scores bit-equal to
``reporter_tpu.matcher.hmm.viterbi_decode_batch``; against the Pallas
kernel (run in interpret mode, as the JAX package's own tests run it)
scores agree within rtol 1e-5 and paths exactly. The CUDA kernel's launch
plan, made on the host, is pinned here too; the kernel itself runs only on
the card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from reporter_tpu.matcher import hmm as jax_hmm
from reporter_tpu.ops.pallas_viterbi import viterbi_pallas_batch
from reporter_tpu_torch import ops
from reporter_tpu_torch.matcher import hmm
from reporter_tpu_torch.matcher.hmm import NORMAL, RESTART, SKIP
from reporter_tpu_torch.ops import viterbi


def random_inputs(B, T, K, seed, with_restarts=True, with_skips=True):
    """Random decode inputs with restarts, a SKIP tail and unreachable
    routes (the JAX package's tests/test_pallas_viterbi.py recipe)."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0.0, 40.0, (B, T, K)).astype(np.float32)
    valid = rng.random((B, T, K)) > 0.1
    valid[:, :, 0] = True
    gc = rng.uniform(5.0, 40.0, (B, T - 1)).astype(np.float32)
    route = (gc[..., None, None]
             + rng.exponential(15.0, (B, T - 1, K, K))).astype(np.float32)
    route[rng.random(route.shape) < 0.05] = 1.0e9
    case = np.full((B, T), NORMAL, dtype=np.int32)
    case[:, 0] = RESTART
    if with_restarts and T > 3:
        for b in range(B):
            for t in rng.integers(2, T - 1, size=2):
                case[b, t] = RESTART
    if with_skips:
        for b in range(B):
            n_skip = int(rng.integers(0, max(T // 4, 1)))
            if n_skip:
                case[b, T - n_skip:] = SKIP
    return (dist, valid, route, gc, case, np.float32(4.07), np.float32(3.0))


def to_f16_wire(args):
    """The f16 wire the matcher ships: unreachable routes overflow to +inf."""
    dist, valid, route, gc, case, sigma, beta = args
    with np.errstate(over="ignore"):
        return (dist.astype(np.float16), valid, route.astype(np.float16),
                gc.astype(np.float16), case, sigma, beta)


def torch_decode(args, fn=hmm.viterbi_decode_batch):
    dist, valid, route, gc, case, sigma, beta = args
    paths, scores = fn(*(torch.from_numpy(a) for a in
                         (dist, valid, route, gc, case)), sigma, beta)
    assert paths.dtype == torch.int32 and scores.dtype == torch.float32
    return paths.numpy(), scores.numpy()


def jax_scan(args):
    paths, scores = jax_hmm.viterbi_decode_batch(*args)
    return np.asarray(paths), np.asarray(scores)


def assert_bit_equal_to_scan(args):
    t_paths, t_scores = torch_decode(args)
    j_paths, j_scores = jax_scan(args)
    np.testing.assert_array_equal(t_paths, j_paths)
    np.testing.assert_array_equal(t_scores.view(np.int32),
                                  j_scores.view(np.int32))
    return t_paths, t_scores


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(4, 16, 4), (3, 33, 8), (2, 64, 8)])
def test_plain_decode_matches_jax(shape, seed):
    args = random_inputs(*shape, seed)
    t_paths, t_scores = assert_bit_equal_to_scan(args)
    p_paths, p_scores = viterbi_pallas_batch(*args, interpret=True)
    np.testing.assert_array_equal(t_paths, np.asarray(p_paths))
    np.testing.assert_allclose(t_scores, np.asarray(p_scores), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_f16_wire_matches_jax(seed):
    args = to_f16_wire(random_inputs(3, 33, 8, seed))
    assert np.isinf(args[2]).any()
    assert_bit_equal_to_scan(args)


def test_route_with_t_rows_matches_trimmed():
    dist, valid, route, gc, case, sigma, beta = random_inputs(3, 16, 8, 4)
    B, T, K = dist.shape
    route_t = np.concatenate([route, np.full((B, 1, K, K), 7.0, np.float32)],
                             axis=1)
    gc_t = np.concatenate([gc, np.full((B, 1), 3.0, np.float32)], axis=1)
    padded = (dist, valid, route_t, gc_t, case, sigma, beta)
    t_paths, t_scores = assert_bit_equal_to_scan(padded)
    want_paths, want_scores = torch_decode(
        (dist, valid, route, gc, case, sigma, beta))
    np.testing.assert_array_equal(t_paths, want_paths)
    np.testing.assert_array_equal(t_scores, want_scores)


def test_single_point_traces():
    dist, valid, route, gc, case, sigma, beta = random_inputs(
        4, 2, 8, 5, with_restarts=False, with_skips=False)
    args = (dist[:, :1], valid[:, :1], route[:, :0], gc[:, :0], case[:, :1],
            sigma, beta)
    paths, _scores = assert_bit_equal_to_scan(args)
    assert paths.shape == (4, 1)


def test_exact_ties_break_to_lowest_index():
    """Co-located candidates (equal distances, equal route rows) tie
    exactly; both decoders must pick the first maximal index."""
    dist, valid, route, gc, case, sigma, beta = random_inputs(3, 16, 8, 6)
    dist[:, :, 1::2] = dist[:, :, 0::2]
    valid[:, :, 1::2] = valid[:, :, 0::2]
    route[:, :, 1::2, :] = route[:, :, 0::2, :]
    route[:, :, :, 1::2] = route[:, :, :, 0::2]
    args = (dist, valid, route, gc, case, sigma, beta)
    paths, _ = assert_bit_equal_to_scan(args)
    assert (paths % 2 == 0).all()


def test_decode_batch_on_cpu_tensors_is_the_plain_version():
    args = to_f16_wire(random_inputs(4, 16, 8, 7))
    before = ops.viterbi_cuda.launches
    got = torch_decode(args, fn=ops.decode_batch)
    want = torch_decode(args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert ops.viterbi_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    dist, valid, route, gc, case, sigma, beta = random_inputs(2, 16, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.viterbi_cuda(*(torch.from_numpy(a) for a in
                           (dist, valid, route, gc, case)), sigma, beta)


PLAN_T = (1, 2, 16, 64, 256, 1024)
PLAN_K = (1, 5, 8, 12, 32, 40, 64, 128)


@pytest.mark.parametrize("K", PLAN_K)
@pytest.mark.parametrize("T", PLAN_T)
def test_launch_plan_fits_one_block_and_covers_the_batch(T, K):
    """The CUDA kernel's launch plan, made on the host: shared memory
    within the 227 KB a Hopper block may use, a power-of-two lane group
    per trace, every trace of the batch in some block, and chunks that
    stream a long trace: at K <= 32 (two scored chunks in flight) at
    least ``MIN_CHUNK`` steps where the trace has them."""
    for B in (1, 37, 512):
        plan = viterbi.launch_plan(B, T, K)
        assert plan.smem_bytes <= viterbi.SMEM_MAX == 232_448
        assert plan.lanes & (plan.lanes - 1) == 0
        assert min(K, 32) <= plan.lanes <= 32
        assert 1 <= plan.traces_per_block
        assert plan.grid * plan.traces_per_block >= B
        assert (plan.grid - 1) * plan.traces_per_block < B
        assert 1 <= plan.chunk_steps <= max(T - 1, 1)
        if K <= viterbi.SMALL_K:
            assert plan.chunk_steps >= min(T - 1, viterbi.MIN_CHUNK)


@pytest.mark.parametrize("K", [0, 129])
def test_launch_plan_refuses_k_outside_1_to_128(K):
    with pytest.raises(ValueError, match="outside 1..128"):
        viterbi.launch_plan(512, 64, K)


def test_kernel_wrapper_refuses_k_above_128():
    """The card takes at most 128 candidates: a matcher on cuda with
    max_candidates > 128 raises rather than decoding elsewhere."""
    args = random_inputs(2, 4, 129, 9, with_restarts=False)
    with pytest.raises(ValueError, match="at most 128"):
        ops.viterbi_cuda(*(torch.from_numpy(a) for a in args[:5]),
                         *args[5:])
