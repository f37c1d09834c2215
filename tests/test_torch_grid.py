"""The port's pixel stream (``render/renderer.py`` ``_swizzled_grid`` and
``pixel_stream``): the tile-major pixel indices over a tile-padded frame,
built on the device asked for.

On the CPU: bit for bit the numpy construction that the JAX package uses
(copied below as the oracle), int32 and contiguous, at frame sizes from
1080p down to a single row, for 16- and 8-pixel tiles.  On the card: the
stream's build, padding included, makes no host-to-device copy and
gives the CPU's values."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracinginonesemester_tpu_torch.render.renderer import (
    _swizzled_grid, pixel_stream)

SIZES = [(1920, 1080), (960, 540), (1000, 563), (48, 16), (16, 16), (17, 1)]


def _numpy_grid(width, height, tile):
    """The numpy construction: ``np.mgrid`` over the padded frame,
    reshaped into tiles and raveled tile by tile."""
    wp = -(-width // tile) * tile
    hp = -(-height // tile) * tile

    def swz(a):
        return (a.reshape(hp // tile, tile, wp // tile, tile)
                .transpose(0, 2, 1, 3).ravel())

    ys, xs = np.mgrid[0:hp, 0:wp]
    return swz(xs).astype(np.int32), swz(ys).astype(np.int32), (hp, wp)


@pytest.mark.parametrize("tile", [16, 8])
@pytest.mark.parametrize("width,height", SIZES)
def test_grid_equals_the_numpy_construction(width, height, tile):
    xs, ys, (hp, wp) = _swizzled_grid(width, height, tile=tile)
    want_xs, want_ys, want_shape = _numpy_grid(width, height, tile)
    assert (hp, wp) == want_shape
    assert hp % tile == 0 and wp % tile == 0
    assert hp >= height and wp >= width
    for got, want in ((xs, want_xs), (ys, want_ys)):
        assert got.dtype == torch.int32
        assert got.device == torch.device("cpu")
        assert got.is_contiguous()
        assert got.shape == (hp * wp,)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
def test_cuda_grid_is_built_on_the_card():
    """At 1080p on the card: no ``Memcpy HtoD`` in the build's profiler
    session, and the CPU build's values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pixel_stream(16, 16, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        xs, ys, n, shape = pixel_stream(1920, 1080, device="cuda")
        torch.cuda.synchronize()
    events = prof.events()
    names = [e.name for e in events]
    # the session saw the card's work, so an absent copy is no blind spot
    assert any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in events), names
    assert any("rt.dispatch.grid" in n for n in names), names
    assert not [n for n in names if "HtoD" in n], names
    assert xs.is_cuda and ys.is_cuda
    want_xs, want_ys, want_n, want_shape = pixel_stream(1920, 1080)
    assert (n, shape) == (want_n, want_shape)
    for got, want in ((xs, want_xs), (ys, want_ys)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert torch.equal(got.cpu(), want)
