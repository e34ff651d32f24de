"""The conv kernel's prepared weights and tile plan, on the CPU.

The kernel (csrc/conv3x3.cu) reads its weights as [tap][chunk][Cout
padded][chunk width]; the conv modules build that layout once per compute
dtype and rebuild it when a parameter changes. These tests hold the layout
against the OIHW weight exactly, the modules' caches against in-place
updates, and the tile plan against the shapes of the serving forward.
"""

import numpy as np
import pytest
import torch

from video_super_resolution_tpu_torch.models.common import ConvLReLU, RoutedConv
from video_super_resolution_tpu_torch.models.fusion import ScoreConv
from video_super_resolution_tpu_torch.ops.fused_conv import (
    conv3x3_plain,
    conv3x3_plan,
    fused_conv3x3,
    prepare_conv3x3_weight,
    unpack_conv3x3_weight,
)
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

BF16, F32 = torch.bfloat16, torch.float32


def weights(cout, cin, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return w, b


@pytest.mark.parametrize("cin,cout,dtype", [
    (3, 64, BF16), (16, 16, BF16), (65, 48, BF16), (627, 32, BF16),
    (256, 256, BF16), (24, 200, BF16), (64, 48, F32), (5, 7, F32)])
def test_prepared_weight_unpacks_exactly(cin, cout, dtype):
    w, b = weights(cout, cin)
    p = prepare_conv3x3_weight(w, b, dtype)
    assert p.packed.dtype == dtype and p.packed.is_contiguous()
    assert p.npad % 16 == 0 and p.npad >= cout and p.kc in (16, 32, 64)
    assert torch.equal(unpack_conv3x3_weight(p), w.to(dtype))
    assert torch.equal(p.bias, b) and p.bias.dtype == F32
    # zero past Cin and Cout, so the padded K and N add nothing
    nchunk = p.packed.shape[1]
    assert p.taps == (1 if cin <= 3 else 9)
    k = 9 * cin if p.taps == 1 else cin     # taps folded into channels
    used = torch.zeros((p.taps, p.npad, nchunk * p.kc), dtype=torch.bool)
    used[:, :cout, :k] = True
    used = used.reshape(p.taps, p.npad, nchunk, p.kc).permute(0, 2, 1, 3)
    assert not p.packed[~used].any()


def test_prepared_layout_is_tap_chunk_cout_channel():
    w, b = weights(40, 70)
    p = prepare_conv3x3_weight(w, b, F32)
    kc = p.kc
    for (o, i, ky, kx) in [(0, 0, 0, 0), (39, 69, 2, 2), (7, 33, 1, 2),
                           (21, 64, 2, 0)]:
        assert p.packed[3 * ky + kx, i // kc, o, i % kc] == w[o, i, ky, kx]


@pytest.mark.parametrize("d", [1, 3])
def test_folded_weight_is_the_conv_over_folded_taps(d):
    """The route for Cin <= 3: the kernel's fold of x (channel
    (3 * ky + kx) * Cin + c = the tap's neighbour, zero outside the image)
    times the folded weight is the 3x3 SAME conv."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 7, 9, 3)).astype(np.float32))
    w, b = weights(8, 3, seed=6)
    p = prepare_conv3x3_weight(w, b, F32)
    assert (p.taps, p.kc) == (1, 32)
    xp = torch.nn.functional.pad(x, (0, 0, d, d, d, d))
    taps = [xp[:, ky * d:ky * d + 7, kx * d:kx * d + 9]
            for ky in range(3) for kx in range(3)]
    xf = torch.cat(taps + [torch.zeros((2, 7, 9, 5))], -1)
    got = xf @ p.packed[0, 0, :8].T + b
    torch.testing.assert_close(got, conv3x3_plain(x, w, b, 1.0, d),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_fused_conv_prepared_equals_oihw(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 6, 9, 12)).astype(np.float32)).to(dtype)
    w, b = weights(8, 12, seed=2)
    res = torch.from_numpy(rng.standard_normal((1, 6, 9, 8)).astype(np.float32))
    p = prepare_conv3x3_weight(w, b, dtype)
    got = fused_conv3x3(x, p, None, 0.1, 2, res, 2)
    assert torch.equal(got, fused_conv3x3(x, w, b, 0.1, 2, res, 2))
    assert torch.equal(got, conv3x3_plain(x, w, b, 0.1, 2, res, 2))


def test_fused_conv_prepared_rejects_what_does_not_fit():
    w, b = weights(8, 12)
    p = prepare_conv3x3_weight(w, b, F32)
    with pytest.raises(ValueError, match="bias"):
        fused_conv3x3(torch.zeros((1, 4, 4, 12)), p, b)
    with pytest.raises(ValueError, match="channels"):
        fused_conv3x3(torch.zeros((1, 4, 4, 10)), p)


def _fill(module, seed=0):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for prm in module.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen))
    return module


@pytest.mark.parametrize("cls", [ConvLReLU, RoutedConv])
def test_module_cache_is_kept_and_rebuilt_after_in_place_update(cls):
    m = _fill(cls(12, 16, dtype=BF16))
    p = m.prepared(BF16)
    assert m.prepared(BF16) is p                      # kept
    assert m.prepared(F32) is not p                   # one per dtype
    with torch.no_grad():
        m.weight.mul_(2.0)
    q = m.prepared(BF16)
    assert q is not p
    assert torch.equal(unpack_conv3x3_weight(q), m.weight.to(BF16))
    with torch.no_grad():
        m.bias.add_(1.0)
    r = m.prepared(BF16)
    assert r is not q and torch.equal(r.bias, m.bias.to(BF16).float())


def test_module_cache_is_rebuilt_after_load_state_dict():
    m = _fill(ConvLReLU(8, 8, dtype=F32))
    p = m.prepared(F32)
    other = _fill(ConvLReLU(8, 8, dtype=F32), seed=5)
    m.load_state_dict(other.state_dict())
    q = m.prepared(F32)
    assert q is not p
    assert torch.equal(unpack_conv3x3_weight(q), other.weight)
    x = torch.randn((1, 5, 6, 8), generator=torch.Generator().manual_seed(3))
    assert torch.equal(m(x), other(x))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_score_conv_halves_split_the_one_weight(dtype):
    m = _fill(ScoreConv(5, 6, 8, dtype=dtype))
    ref = m.prepared(dtype, slice(None, 5), False)
    nbr = m.prepared(dtype, slice(5, None))
    assert (ref.cin, nbr.cin, ref.cout, nbr.cout) == (5, 6, 8, 8)
    both = torch.cat([unpack_conv3x3_weight(ref), unpack_conv3x3_weight(nbr)], 1)
    assert torch.equal(both, m.weight.to(dtype))
    assert not ref.bias.any()
    assert torch.equal(nbr.bias, m.bias.to(dtype).float())


@pytest.mark.parametrize("shape,cout,dtype,route,kc,bn,split", [
    ((1, 540, 960, 128), 64, BF16, "tma", 64, 64, False),      # SR trunk
    ((1, 540, 960, 64), 128, BF16, "tma", 64, 128, False),
    ((2, 544, 960, 66), 64, BF16, "tma+pad", 64, 64, False),   # score
    ((3, 544, 960, 3), 64, BF16, "fold", 32, 64, False),      # encoder
    ((3, 272, 480, 16), 16, BF16, "tma", 16, 16, False),       # depth
    ((2, 17, 30, 627), 32, BF16, "tma+pad", 64, 32, True),     # estimator
    ((3, 9, 16, 256), 256, BF16, "tma", 64, 128, True),        # depth
    ((1, 540, 960, 64), 48, F32, "tma", 32, 48, False),        # subpixel
])
def test_conv_plan_at_serving_shapes(shape, cout, dtype, route, kc, bn, split):
    p = conv3x3_plan(shape, cout, dtype)
    assert (p.route, p.kc, p.bn) == (route, kc, bn)
    assert p.cx % 8 == 0 and p.cx >= shape[3]
    assert p.tw * p.th == (128 if dtype == BF16 else 256)
    assert p.npad % p.bn == 0 and p.npad >= cout
    assert (p.splits > 1) == split
    # every split has steps, and they cover the taps x chunks once
    nk = (1 if route == "fold" else 9) * -(-p.cx // p.kc)
    per = -(-nk // p.splits)
    assert (p.splits - 1) * per < nk <= p.splits * per
