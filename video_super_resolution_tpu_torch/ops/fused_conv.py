"""Fused 3x3 conv + bias (+ residual) + LeakyReLU on NHWC activations.

``fused_conv3x3`` launches the CUDA kernel ``csrc/conv3x3.cu`` for CUDA
tensors and runs ``conv3x3_plain``, the same function in plain PyTorch, for
CPU tensors. It is the port of the JAX package's ``fused_conv3x3`` and of
the math of ``fused_conv3x3_packed`` (whose pixel-pair layout only served
the TPU): every stride-1 3x3 conv of the model, any dilation and any Cin.

The kernel reads its weights in a layout of its own,
[tap][channel chunk][Cout padded][chunk] in the compute dtype, which
``prepare_conv3x3_weight`` builds from the OIHW parameter. The model's conv
modules build it once per dtype and keep it (``models/common.py``);
``fused_conv3x3`` also takes the OIHW weight and prepares it per call.
``conv3x3_plan`` is the tile plan the wrapper hands the kernel.

Gradients: with grad enabled and an input that requires it, the forward
runs inside ``_Conv3x3Fn`` (an autograd Function) and ``conv3x3_backward``
gives the gradients: the counterpart of the JAX package's ``_fc_bwd``,
which is XLA's vjp of the plain conv, not a Pallas kernel. The backward
never reruns the forward: the LeakyReLU's derivative comes from the saved
output, dx and dW from cuDNN's (or the CPU's) conv gradients.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from video_super_resolution_tpu_torch.ops import _build
from video_super_resolution_tpu_torch.ops.pixel_shuffle import pixel_shuffle

_DTYPES = (torch.float32, torch.bfloat16)
# output-tile widths the bf16 kernel is built for (wgmma N); f32: 32, 48, 64
_BF16_BN = (16, 32, 48, 64, 96, 128)
H100_SMS = 132


@dataclasses.dataclass(frozen=True, eq=False)
class PreparedConv3x3:
    """A 3x3 conv's weight in the kernel's layout, and its f32 bias.

    packed: (9, nchunk, npad, kc) in the compute dtype, tap = 3 * ky + kx,
    input channel = chunk * kc + j, zero past cin and cout; for cin <=
    FOLD_CIN, with the taps folded into the channels, (1, 1, npad, 32) with
    channel (3 * ky + kx) * cin + c."""

    packed: torch.Tensor
    bias: torch.Tensor
    cin: int
    cout: int

    @property
    def dtype(self) -> torch.dtype:
        return self.packed.dtype

    @property
    def taps(self) -> int:
        return self.packed.shape[0]

    @property
    def kc(self) -> int:
        return self.packed.shape[3]

    @property
    def npad(self) -> int:
        return self.packed.shape[2]


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


FOLD_CIN = 3    # up to this Cin the 9 taps are folded into 32 channels


def _geometry(cin: int, cout: int, dtype: torch.dtype):
    """Taps the kernel steps over (9, or 1 with the taps folded into the
    channels), channels it reads (cx: a 16-byte pixel row for TMA), channel
    chunk kc, output-tile width bn and padded Cout."""
    taps = 1 if cin <= FOLD_CIN else 9
    if dtype == torch.bfloat16:
        cx = 32 if taps == 1 else _round_up(cin, 8)
        kc = 16 if cx <= 16 else (32 if cx <= 32 else 64)
        bn = next(n for n in _BF16_BN if n >= min(cout, 128))
    else:
        cx, kc = (32 if taps == 1 else _round_up(cin, 8)), 32
        bn = 32 if cout <= 32 else (48 if cout <= 48 else 64)
    return taps, cx, kc, bn, _round_up(cout, bn)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How the kernel runs one conv: the staging route ("tma": x read as it
    is; "tma+pad": x first copied with channels zero-padded to cx; "fold":
    x first copied with its 9 taps folded into cx channels; both copies by
    the kernel library), the channel chunk, the output tile (bm = th x tw
    pixels, bn channels), the number of output tiles and the split-K
    factor."""

    route: str
    cx: int
    kc: int
    bn: int
    npad: int
    tw: int
    th: int
    tiles: int
    splits: int


@functools.lru_cache(maxsize=1024)
def conv3x3_plan(shape, cout: int, dtype: torch.dtype,
                 sms: int = H100_SMS) -> ConvPlan:
    """Tile plan for x of NHWC ``shape`` -> ``cout`` channels: the pixel
    rectangle that wastes the fewest rows at the ragged edges (wider first
    on a tie), and split-K over the 9 * nchunk (tap, chunk) steps when the
    output tiles alone would leave SMs idle, keeping >= 4 steps a split."""
    bsz, h, w, cin = shape
    taps, cx, kc, bn, npad = _geometry(cin, cout, dtype)
    bm = 128 if dtype == torch.bfloat16 else 256
    widths = [t for t in (256, 128, 64, 32, 16) if t <= bm and bm // t <= 256]
    tw = min(widths, key=lambda t: _round_up(w, t) * _round_up(h, bm // t))
    th = bm // tw
    tiles = bsz * -(-h // th) * -(-w // tw) * (npad // bn)
    nk = taps * -(-cx // kc)
    splits = 1
    if tiles < sms:
        want = min(-(-sms // tiles), max(1, nk // 4))
        per = -(-nk // want)
        splits = -(-nk // per)          # no split without steps
    route = "fold" if taps == 1 else ("tma" if cx == cin else "tma+pad")
    return ConvPlan(route, cx, kc, bn, npad, tw, th, tiles, splits)


def prepare_conv3x3_weight(w: torch.Tensor, b: torch.Tensor,
                           dtype: torch.dtype) -> PreparedConv3x3:
    """OIHW ``w`` (cast to ``dtype``) and bias ``b`` (read in f32: callers
    round it first where the reference does) in the kernel's layout."""
    if w.ndim != 4 or w.shape[2:] != (3, 3) or b.shape != (w.shape[0],):
        raise ValueError(f"prepare_conv3x3_weight: w {tuple(w.shape)} must be "
                         f"OIHW 3x3 and b {tuple(b.shape)} (Cout,)")
    if dtype not in _DTYPES:
        raise TypeError(f"prepare_conv3x3_weight: dtype {dtype} not in {_DTYPES}")
    cout, cin = w.shape[:2]
    taps, cx, kc, _, npad = _geometry(cin, cout, dtype)
    nchunk = -(-cx // kc)
    with torch.no_grad():
        if taps == 1:       # [o, (3 * ky + kx) * cin + c]
            k = w.to(dtype).permute(0, 2, 3, 1).reshape(1, cout, 9 * cin)
        else:
            k = w.to(dtype).permute(2, 3, 0, 1).reshape(9, cout, cin)
        buf = k.new_zeros((taps, npad, nchunk * kc))
        buf[:, :cout, :k.shape[2]] = k
        packed = (buf.reshape(taps, npad, nchunk, kc).permute(0, 2, 1, 3)
                  .contiguous())
        bias = b.to(torch.float32).clone()
    return PreparedConv3x3(packed, bias, cin, cout)


def unpack_conv3x3_weight(p: PreparedConv3x3) -> torch.Tensor:
    """The OIHW weight (in the prepared dtype) back from the kernel layout."""
    nchunk = p.packed.shape[1]
    buf = p.packed.permute(0, 2, 1, 3).reshape(p.taps, p.npad, nchunk * p.kc)
    if p.taps == 1:
        return (buf[0, :p.cout, :9 * p.cin].reshape(p.cout, 3, 3, p.cin)
                .permute(0, 3, 1, 2).contiguous())
    return (buf[:, :p.cout, :p.cin].reshape(3, 3, p.cout, p.cin)
            .permute(2, 3, 0, 1).contiguous())


def _check(x, cin, cout, res, res_repeat, dilation):
    if x.ndim != 4:
        raise ValueError(f"fused_conv3x3: x {tuple(x.shape)} must be NHWC")
    bsz, h, wd, xc = x.shape
    if xc != cin:
        raise ValueError(f"fused_conv3x3: x has {xc} channels, the weight "
                         f"takes {cin}")
    if dilation < 1 or res_repeat < 1:
        raise ValueError("fused_conv3x3: dilation and res_repeat must be >= 1")
    if res is not None:
        if bsz % res_repeat:
            raise ValueError(f"fused_conv3x3: batch {bsz} not divisible by "
                             f"res_repeat {res_repeat}")
        want = (bsz // res_repeat, h, wd, cout)
        if tuple(res.shape) != want:
            raise ValueError(f"fused_conv3x3: res {tuple(res.shape)} != {want}")


def _check_oihw(x, w, b, res, res_repeat, dilation):
    if w.ndim != 4 or w.shape[2:] != (3, 3):
        raise ValueError(f"fused_conv3x3: w {tuple(w.shape)} must be OIHW 3x3")
    if b is None or b.shape != (w.shape[0],):
        raise ValueError(f"fused_conv3x3: w {tuple(w.shape)} / b "
                         f"{None if b is None else tuple(b.shape)} do not fit")
    _check(x, w.shape[1], w.shape[0], res, res_repeat, dilation)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  slope: float = 0.1, dilation: int = 1,
                  res: Optional[torch.Tensor] = None,
                  res_repeat: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel: conv of the input values with
    f32 accumulation, + bias (+ res broadcast over groups of ``res_repeat``
    batch items), LeakyReLU, one rounding to x's dtype."""
    _check_oihw(x, w, b, res, res_repeat, dilation)
    xf = x.permute(0, 3, 1, 2).to(torch.float32)
    out = F.conv2d(xf, w.to(x.dtype).to(torch.float32), None,
                   padding=dilation, dilation=dilation)
    out = out.permute(0, 2, 3, 1) + b.to(torch.float32)
    if res is not None:
        out = out + torch.repeat_interleave(res.to(torch.float32),
                                            res_repeat, dim=0)
    out = torch.where(out >= 0, out, slope * out)
    return out.to(x.dtype).contiguous()


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


_sms: dict = {}


def _sm_count(device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


def _conv3x3_cuda(x, prep, slope, dilation, res, res_repeat):
    if prep.dtype != x.dtype:
        raise TypeError(f"fused_conv3x3: weight prepared for {prep.dtype}, "
                        f"x is {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_conv3x3: x must be contiguous NHWC")
    if res is not None:
        if res.dtype not in (x.dtype, torch.float32):
            raise TypeError(f"fused_conv3x3: res dtype {res.dtype}")
        if not res.is_contiguous():
            raise ValueError("fused_conv3x3: res must be contiguous")
    bsz, h, wd, cin = x.shape
    out = torch.empty((bsz, h, wd, prep.cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = conv3x3_plan(tuple(x.shape), prep.cout, x.dtype, _sm_count(x.device))
    tma_x = x if plan.route == "tma" else None     # staging reads scalars
    for name, t in (("x", tma_x), ("res", res), ("bias", prep.bias),
                    ("weight", prep.packed)):
        if t is not None and not _aligned(t):
            raise ValueError(f"fused_conv3x3: {name} must be 16-byte aligned "
                             f"for TMA and vector loads (data_ptr "
                             f"{t.data_ptr():#x})")
    staged = None        # TMA needs 16-byte pixel rows: pad or fold first
    if plan.route != "tma":
        staged = torch.empty((bsz, h, wd, plan.cx), dtype=x.dtype,
                             device=x.device)
    ws = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, bsz * h * wd, prep.npad),
                         dtype=torch.float32, device=x.device)
    lib = _build.lib()
    # switching devices costs host time a call; skip it when x's is current
    current = x.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(x.device):
        rc = lib.vsr_conv3x3(
            x.data_ptr(), prep.packed.data_ptr(), prep.bias.data_ptr(),
            res.data_ptr() if res is not None else None, out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            staged.data_ptr() if staged is not None else None,
            int(plan.route == "fold"), bsz, h, wd, cin, plan.cx, prep.cout,
            prep.npad, plan.bn, plan.kc, plan.tw, plan.splits, dilation,
            float(slope), res_repeat,
            int(res is not None and res.dtype == torch.float32),
            int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check_launch("conv3x3", rc)
    fused_conv3x3.launches += 1
    return out


def conv3x3_backward(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     out: torch.Tensor, slope: float = 0.1, dilation: int = 1,
                     res_repeat: int = 1,
                     res_dtype: Optional[torch.dtype] = None,
                     needs=(True, True, True, True)):
    """Gradients of ``fused_conv3x3`` (before any shuffle) from the output's
    gradient ``g`` and the saved input ``x``, OIHW weight ``w`` and output
    ``out``: (dx, dw, db, dres), each None where ``needs`` says so; dres is
    None too without a residual (``res_dtype`` None).

    As XLA's vjp of the JAX package's ``_xla_conv``: the LeakyReLU passes g
    where the output is >= 0 (slope > 0 keeps the sign of its input) and
    slope * g elsewhere, in g's dtype; dx and dw are the conv's input and
    weight gradients computed in x's dtype (bf16 x and g in bf16, with f32
    accumulation inside), dw returned in w's dtype; db and dres are f32
    sums, dres over each group of ``res_repeat`` batch items."""
    gp = g if slope == 1.0 else torch.where(out >= 0, g, g * slope)
    dt = x.dtype
    gn = gp.to(dt).permute(0, 3, 1, 2)
    pad = dict(padding=dilation, dilation=dilation)
    dx = dw = db = dres = None
    if needs[0]:
        shape = (x.shape[0], x.shape[3], x.shape[1], x.shape[2])
        dx = torch.nn.grad.conv2d_input(shape, w.to(dt), gn, **pad
                                        ).permute(0, 2, 3, 1).contiguous()
    if needs[1]:
        dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), w.shape, gn,
                                         **pad).to(w.dtype)
    if needs[2]:
        db = gp.to(torch.float32).sum(dim=(0, 1, 2))
    if needs[3] and res_dtype is not None:
        b, h, wd, c = gp.shape
        dres = (gp.to(torch.float32).reshape(b // res_repeat, res_repeat,
                                             h, wd, c)
                .sum(dim=1).to(res_dtype))
    return dx, dw, db, dres


def _conv3x3_forward(x, prep, w, b, slope, dilation, res, res_repeat):
    """The kernel for CUDA tensors, the plain version for CPU ones; ``prep``
    (the prepared weight) or else the OIHW ``w`` and ``b``."""
    if x.device.type == "cpu":
        if prep is not None:
            w, b = unpack_conv3x3_weight(prep), prep.bias
        return conv3x3_plain(x, w, b, slope, dilation, res, res_repeat)
    tensors = [x, prep.packed if prep is not None else w]
    _build.require_cuda("fused_conv3x3", *tensors,
                        *([res] if res is not None else []))
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv3x3: dtype {x.dtype} not in {_DTYPES}")
    if prep is None:
        prep = prepare_conv3x3_weight(w, b, x.dtype)
    return _conv3x3_cuda(x, prep, slope, dilation, res, res_repeat)


class _Conv3x3Fn(torch.autograd.Function):
    """The fused conv with gradients to x, the OIHW ``w``, the bias ``b``
    (None: no bias) and ``res``; ``prep`` is the kernel layout of (w, b)
    or None."""

    @staticmethod
    def forward(ctx, x, w, b, res, prep, slope, dilation, res_repeat):
        out = _conv3x3_forward(x, prep, w, b, slope, dilation, res,
                               res_repeat)
        ctx.save_for_backward(x, w, out)
        ctx.conf = (slope, dilation, res_repeat,
                    None if res is None else res.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        slope, dilation, res_repeat, res_dtype = ctx.conf
        dx, dw, db, dres = conv3x3_backward(
            g, x, w, out, slope, dilation, res_repeat, res_dtype,
            ctx.needs_input_grad[:4])
        return dx, dw, db, dres, None, None, None, None


def fused_conv3x3(x: torch.Tensor, w: Union[torch.Tensor, PreparedConv3x3],
                  b: Optional[torch.Tensor] = None, slope: float = 0.1,
                  dilation: int = 1, res: Optional[torch.Tensor] = None,
                  res_repeat: int = 1, shuffle: bool = False,
                  params: Optional[Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]] = None
                  ) -> torch.Tensor:
    """3x3 SAME conv + bias (+ res) + LeakyReLU (+ pixel_shuffle(2)).

    x: (B, H, W, Cin) NHWC, f32 or bf16. w: a ``PreparedConv3x3`` for x's
    dtype (it carries the bias; b must be None), or a (Cout, Cin, 3, 3)
    OIHW weight, cast to x's dtype, with b: (Cout,), read in f32 (callers
    round it first where the reference does). res: optional
    (B // res_repeat, H, W, Cout) residual in x's dtype or f32, added before
    the activation and shared by each group of ``res_repeat`` consecutive
    batch items. slope=1.0 makes the activation the identity. Output dtype
    = x's dtype.

    Differentiable in x, res and the weights: an OIHW w and b themselves,
    or, for a prepared w, ``params`` = (OIHW weight, f32 bias or None for a
    zero bias) that it was prepared from. Without grad enabled, or with no
    input that requires it, the forward runs with no autograd Function.
    """
    if isinstance(w, PreparedConv3x3):
        if b is not None:
            raise ValueError("fused_conv3x3: a prepared weight carries its bias")
        prep = w
        _check(x, prep.cin, prep.cout, res, res_repeat, dilation)
        pw, pb = params if params is not None else (None, None)
    else:
        prep = None
        _check_oihw(x, w, b, res, res_repeat, dilation)
        pw, pb = w, b
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, pw, pb, res)):
        if pw is None:
            raise ValueError("fused_conv3x3: gradients through a prepared "
                             "weight need its params=(weight, bias)")
        out = _Conv3x3Fn.apply(x, pw, pb, res, prep, slope, dilation,
                               res_repeat)
    else:
        out = _conv3x3_forward(x, prep, w, b, slope, dilation, res,
                               res_repeat)
    return pixel_shuffle(out, 2) if shuffle else out


fused_conv3x3.launches = 0
