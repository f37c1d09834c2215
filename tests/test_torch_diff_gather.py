"""Kernel J of the PyTorch port (``ops.diff_gather``): the deterministic
scatter-accumulate behind ``gather_rows``' backward pass.

On the CPU ``segment_accum_rows`` runs its plain version (``index_add_``
on the host, in ascending ray order), held here against an explicit loop
bit for bit and against the JAX package's Pallas kernel in interpret
mode.  Tolerance against JAX: 4 ulp, or 1e-6 of the bin's sum of |ct|
(the JAX kernel adds a 512-ray tile through one matrix product before
the next tile, the port adds ray by ray).  ``gather_rows``: forward
exact, backward against the JAX custom VJP's gradient at the same
bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu.ops import diff_gather as jdg
from raytracinginonesemester_tpu_torch.ops import diff_gather as tdg

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _inputs(t, r, f, seed):
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, t, r).astype(np.int32)
    ct = rs.standard_normal((r, f)).astype(np.float32)
    return idx, ct


def _bin_abs_sums(idx, ct, t):
    keep = (idx >= 0) & (idx < t)
    out = np.zeros((t, ct.shape[1]), np.float64)
    np.add.at(out, idx[keep], np.abs(ct[keep]).astype(np.float64))
    return out


def _close_to_jax(got, want, idx, ct, t):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = np.maximum(4 * np.spacing(np.maximum(np.abs(got), np.abs(want))),
                     1e-6 * _bin_abs_sums(idx, ct, t))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (diff <= tol).all(), f"{(diff > tol).sum()} bins beyond tolerance"


@pytest.mark.parametrize("f", [1, 9, 16])
@pytest.mark.parametrize("t,r", [(100, 3000), (jdg._TC + 123, 700), (7, 512)])
def test_segment_accum_matches_jax(t, r, f):
    """The (T, R) cases of ``tests/test_diff_gather.py`` at F = 1, 9, 16."""
    idx, ct = _inputs(t, r, f, t + r + f)
    want = jdg.segment_accum_rows(jnp.asarray(idx), jnp.asarray(ct), t,
                                  interpret=True)
    got = tdg.segment_accum_rows(torch.from_numpy(idx), torch.from_numpy(ct),
                                 t)
    assert tuple(got.shape) == (t, f)
    _close_to_jax(got.numpy(), want, idx, ct, t)


def test_segment_accum_drops_out_of_range():
    rs = np.random.RandomState(0)
    t, r = 50, 900
    idx = rs.randint(0, t, r).astype(np.int32)
    idx[::7] = -1
    idx[::11] = t + 5
    ct = rs.standard_normal((r, 9)).astype(np.float32)
    want = jdg.segment_accum_rows(jnp.asarray(idx), jnp.asarray(ct), t,
                                  interpret=True)
    got = tdg.segment_accum_rows(torch.from_numpy(idx), torch.from_numpy(ct), t)
    _close_to_jax(got.numpy(), want, idx, ct, t)
    keep = (idx >= 0) & (idx < t)
    only_kept = tdg.segment_accum_rows(torch.from_numpy(idx[keep]),
                                       torch.from_numpy(ct[keep]), t)
    assert torch.equal(got, only_kept)


@pytest.mark.parametrize("threads", [1, 4])
def test_plain_adds_in_ascending_ray_order(threads):
    """The plain version equals an explicit loop that adds each ray's
    row to its bin in ascending ray order, bit for bit (the order the
    CUDA kernel keeps), with wide magnitudes so that another order
    would round differently, and with any thread count."""
    rs = np.random.RandomState(3)
    t, r, f = 37, 6000, 5
    idx = rs.randint(-3, t + 3, r).astype(np.int32)
    ct = (rs.standard_normal((r, f))
          * 10.0 ** rs.uniform(-4, 4, (r, f))).astype(np.float32)
    want = np.zeros((t, f), np.float32)
    for i in range(r):
        if 0 <= idx[i] < t:
            want[idx[i]] = want[idx[i]] + ct[i]
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = tdg.segment_accum_rows_plain(torch.from_numpy(idx),
                                           torch.from_numpy(ct), t)
    finally:
        torch.set_num_threads(n)
    np.testing.assert_array_equal(got.numpy(), want)
    # another order differs somewhere: the test can see an order change
    rev = np.zeros((t, f), np.float32)
    for i in reversed(range(r)):
        if 0 <= idx[i] < t:
            rev[idx[i]] = rev[idx[i]] + ct[i]
    assert not np.array_equal(rev, want)


def test_segment_accum_checks_its_inputs():
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 16"):
        tdg.segment_accum_rows(idx, torch.zeros(4, 17), 3)
    with pytest.raises(ValueError, match="float32"):
        tdg.segment_accum_rows(idx, torch.zeros(4, 2, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="integer"):
        tdg.segment_accum_rows(idx.float(), torch.zeros(4, 2), 3)
    with pytest.raises(ValueError, match="at most 16"):
        tdg.gather_rows(torch.zeros(5, 3, 6), idx)


@pytest.mark.parametrize("trail", [(3, 3), (13,), ()])
def test_gather_rows_forward_exact_backward_matches_jax(trail):
    rs = np.random.RandomState(1)
    t, r = 300, 2000
    table = rs.standard_normal((t,) + trail).astype(np.float32)
    idx = rs.randint(-2, t + 2, r).astype(np.int32)  # clamped forward
    w = rs.standard_normal((r,) + trail).astype(np.float32)

    tb = torch.from_numpy(table).requires_grad_(True)
    out = tdg.gather_rows(tb, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  table[np.clip(idx, 0, t - 1)])
    (out * torch.from_numpy(w)).sum().backward()

    want = jax.grad(lambda x: jnp.sum(
        jdg.gather_rows(t, True, x, jnp.asarray(idx)) * w))(jnp.asarray(table))
    f = int(np.prod(trail)) if trail else 1
    ct = w.reshape(r, f)
    _close_to_jax(tb.grad.numpy().reshape(t, f), np.asarray(want).reshape(t, f),
                  idx, ct, t)


def test_gather_rows_backward_goes_through_segment_accum(monkeypatch):
    """The table gradient comes from ``segment_accum_rows``, never from
    autograd's own index backward; the index gets none."""
    calls = []
    real = tdg.segment_accum_rows

    def spy(*a):
        calls.append(a[2])
        return real(*a)

    monkeypatch.setattr(tdg, "segment_accum_rows", spy)
    table = torch.randn(10, 3, requires_grad=True)
    idx = torch.tensor([0, 3, 3, 9])
    out = tdg.gather_rows(table, idx)
    assert "GatherRows" in type(out.grad_fn).__name__
    out.sum().backward()
    assert calls == [10]
    assert table.grad[3].tolist() == [2.0, 2.0, 2.0]


def test_gather_int_rows_clamps():
    table = torch.tensor([5, 6, 7], dtype=torch.int32)
    got = tdg.gather_int_rows(table, torch.tensor([-1, 0, 2, 9]))
    assert got.tolist() == [5, 5, 7, 7]


@pytest.mark.cuda
def test_cuda_segment_accum_bit_for_bit():
    """Kernel J on the card equals its plain version bit for bit, at F =
    1, 9 and 16, with out-of-range ids and one bin holding most rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    rs = np.random.RandomState(5)
    for f in (1, 9, 16):
        t, r = 2048, 200_000
        idx = rs.randint(-1, t + 1, r).astype(np.int32)
        idx[rs.uniform(size=r) < 0.6] = 0
        ct = rs.standard_normal((r, f)).astype(np.float32)
        i, c = torch.from_numpy(idx).cuda(), torch.from_numpy(ct).cuda()
        tdg.reset_launch_counts()
        got = tdg.segment_accum_rows(i, c, t)
        torch.cuda.synchronize()
        assert tdg.launch_counts()["segment_accum"] == 1
        assert torch.equal(got.cpu(), tdg.segment_accum_rows_plain(i, c, t)
                           .cpu())
