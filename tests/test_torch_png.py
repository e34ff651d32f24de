"""The port's self-contained PNG decoder (``csrc/png_decode.h``, reached
through ``data/native_loader.decode_png``) against the JAX package's libpng
binding of ``native/vsr_dataio.cc`` and against PIL, bit for bit.

The PNGs are written here byte by byte (Python's ``zlib``), so that every
flavour exists: colour types 0, 2, 3, 4 and 6 at every legal depth, each
filter type forced, stored and compressed zlib streams, several IDAT
chunks, tRNS chunks. Each decode is held three ways: the port against the
libpng binding (``assert_array_equal``), against PIL's bytes times
float32(1/255) (the C code's ``byte * (1/255.f)``), and against the
samples that were written. Corrupt files raise ``IOError`` in both
bindings; an interlaced file raises in the port (the JAX reader does not
turn on libpng's interlace handling, so it has no result to match).

One divergence, a fault of the JAX reader: for an image with a tRNS chunk
and no alpha channel (gray, RGB or palette) it asks libpng for
``png_set_tRNS_to_alpha`` but strips alpha only from colour types that
have it (``native/vsr_dataio.cc:66-68``), so libpng hands it RGBA rows, of
which it reads the first 3 x width bytes as RGB. The port drops the alpha,
as PIL and the JAX package's Python loader (``data/dataset.py:load_frame``)
do; the tests hold the JAX binding to the misread rows
(``jax_trns_reading``), so that the divergence is pinned exactly.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from video_super_resolution_tpu.data import native_loader as jnative

from video_super_resolution_tpu_torch.data import native_loader as pnative
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

INV255 = np.float32(1.0 / 255.0)
SIG = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
SIZES = ((1, 1), (3, 5), (17, 33))
# Adam7: (row start, column start, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


@pytest.fixture(scope="module")
def jax_binding():
    if not pnative.available():
        pytest.skip(f"port's native loader not buildable: {pnative.missing()}")
    if not jnative.available():
        pytest.skip("native/libvsr_dataio.so not built (make -C native)")
    return jnative


# ------------------------------------------------------------- PNG writer

def chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body)))


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, rowbytes) uint8 scanlines, big-endian for
    16 bits, MSB first below 8."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def filter_row(ft: int, cur: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    c = cur.astype(np.int32)
    b = prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), c[:-bpp]])[:len(c)]
    ul = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])[:len(c)]
    if ft == 0:
        pred = np.zeros_like(c)
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = b
    elif ft == 3:
        pred = (a + b) // 2
    else:
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    return ((c - pred) & 255).astype(np.uint8)


def scanlines(samples, depth, filters):
    ch = samples.shape[2]
    bpp = max(1, ch * depth // 8)
    rows = pack_rows(samples, depth)
    prev = np.zeros(rows.shape[1], np.uint8)
    out = []
    for y, row in enumerate(rows):
        ft = filters[y % len(filters)]
        out.append(bytes([ft]) + filter_row(ft, row, prev, bpp).tobytes())
        prev = row
    return b"".join(out)


def png(samples, color, depth, *, palette=None, trns=None, filters=(0,),
        level=6, idats=1, interlace=False) -> bytes:
    """A PNG of ``samples`` (h, w, channels) at ``color``/``depth``; row y
    uses filter ``filters[y % len(filters)]``; the zlib stream at
    ``level`` is cut into ``idats`` IDAT chunks."""
    h, w, _ = samples.shape
    if interlace:
        raw = b"".join(scanlines(samples[r0::dr, c0::dc], depth, filters)
                       for r0, c0, dr, dc in ADAM7
                       if samples[r0::dr, c0::dc].size)
    else:
        raw = scanlines(samples, depth, filters)
    z = zlib.compress(raw, level)
    cuts = np.linspace(0, len(z), idats + 1).astype(int)
    out = SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                           0, int(interlace)))
    out += chunk(b"tEXt", b"Comment\x00written by test_torch_png")
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    for i in range(idats):
        out += chunk(b"IDAT", z[cuts[i]:cuts[i + 1]])
    return out + chunk(b"IEND", b"")


def image(color, depth, h, w, seed=0):
    """Random samples and, for a palette image, a palette that covers them."""
    rng = np.random.default_rng(seed)
    top = 255 if color == 3 and depth == 8 else (1 << depth) - 1
    samples = rng.integers(0, top + 1, (h, w, CHANNELS[color]))
    if h * w > 1:       # the extremes, so every bit of a sample is used
        samples.reshape(-1, samples.shape[2])[:2] = [[0], [top]]
    palette = (rng.integers(0, 256, (1 << min(depth, 8), 3))
               if color == 3 else None)
    return samples, palette


def truth(samples, color, depth, palette=None) -> np.ndarray:
    """What libpng's transforms give: (h, w, 3) uint8."""
    if color == 3:
        return palette[samples[..., 0]].astype(np.uint8)
    v = samples[..., :3] if color in (2, 6) else np.repeat(samples[..., :1], 3, 2)
    if depth == 16:
        v = v >> 8
    elif depth < 8:
        v = v * (255 // ((1 << depth) - 1))
    return v.astype(np.uint8)


def pil_rgb(path) -> np.ndarray:
    with Image.open(path) as im:
        if im.mode.startswith("I"):         # 16-bit gray: all 16 bits kept
            g = (np.asarray(im).astype(np.int64) >> 8).astype(np.uint8)
            return np.repeat(g[..., None], 3, 2)
        return np.asarray(im.convert("RGB"))


def jax_trns_reading(rgb, alpha) -> np.ndarray:
    """The JAX reader's result for an image with tRNS and no alpha
    channel: the RGBA rows libpng gives it, the first 3 x width bytes of
    each read as RGB."""
    h, w, _ = rgb.shape
    rgba = np.concatenate([rgb, alpha[..., None].astype(np.uint8)], -1)
    return rgba.reshape(h, 4 * w)[:, :3 * w].reshape(h, w, 3)


def trns_alpha(samples, color, trns) -> np.ndarray:
    """libpng's alpha from tRNS: a palette entry's alpha (255 past the
    chunk), or 0 where the sample equals the gray or RGB key."""
    if color == 3:
        a = np.append(np.frombuffer(trns, np.uint8), np.uint8(255))
        return a[np.minimum(samples[..., 0], len(a) - 1)]
    key = np.array(struct.unpack(f">{len(trns) // 2}H", trns))
    return np.where((samples[..., :len(key)] == key).all(-1), 0, 255)


def check(tmp_path, data: bytes, want: np.ndarray, jax_binding,
          jax_want=None) -> None:
    """The port's decode of ``data`` equals the libpng binding's (or
    ``jax_want``, where that one diverges), PIL's and ``want``."""
    path = tmp_path / "x.png"
    path.write_bytes(data)
    got = pnative.decode_png(str(path))
    assert got.dtype == np.float32 and got.shape == want.shape
    theirs = jax_binding.decode_png(str(path))
    if jax_want is None:
        np.testing.assert_array_equal(got, theirs)
    else:
        np.testing.assert_array_equal(theirs, jax_want * INV255)
    np.testing.assert_array_equal(got, pil_rgb(path) * INV255)
    np.testing.assert_array_equal(got, want * INV255)
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), want)


# ------------------------------------------------------------------ cases

@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("color,depth", [(c, d) for c in DEPTHS for d in DEPTHS[c]])
def test_colour_type_and_depth(tmp_path, jax_binding, color, depth, h, w):
    samples, palette = image(color, depth, h, w)
    data = png(samples, color, depth, palette=palette, filters=(0, 1, 2, 3, 4))
    check(tmp_path, data, truth(samples, color, depth, palette), jax_binding)


@pytest.mark.parametrize("color,depth", [(2, 8), (6, 16), (0, 2), (3, 4)])
@pytest.mark.parametrize("ft", range(5))
def test_filter_type(tmp_path, jax_binding, ft, color, depth):
    """Every row of one filter type; bytes per pixel 3, 8 and the sub-byte
    rule's 1."""
    samples, palette = image(color, depth, 17, 33, seed=ft)
    data = png(samples, color, depth, palette=palette, filters=(ft,))
    check(tmp_path, data, truth(samples, color, depth, palette), jax_binding)


@pytest.mark.parametrize("color,depth", [(2, 8), (0, 16)])
@pytest.mark.parametrize("level", [0, 1, 9])
def test_zlib_level(tmp_path, jax_binding, level, color, depth):
    """Level 0 writes stored blocks, 1 fixed and dynamic Huffman blocks,
    9 the longest matches. A smooth ramp gives 1 and 9 matches to find."""
    samples, _ = image(color, depth, 40, 97, seed=level)
    ramp = np.arange(40 * 97 * CHANNELS[color]).reshape(samples.shape)
    samples = np.where(np.arange(40)[:, None, None] % 3 == 0, samples,
                       ramp % (1 << depth))
    data = png(samples, color, depth, filters=(0, 2, 4), level=level)
    check(tmp_path, data, truth(samples, color, depth), jax_binding)


@pytest.mark.parametrize("idats", [2, 5, 10_000])
def test_several_idat_chunks(tmp_path, jax_binding, idats):
    """The zlib stream cut into 2, 5, and (10 000 asked) one-byte chunks
    and empty ones."""
    samples, _ = image(6, 8, 17, 33)
    data = png(samples, 6, 8, filters=(4, 1), idats=idats)
    check(tmp_path, data, truth(samples, 6, 8), jax_binding)


TRNS = {"gray8": (0, 8, struct.pack(">H", 60)),
        "gray2": (0, 2, struct.pack(">H", 1)),
        "gray16": (0, 16, struct.pack(">H", 300)),
        "rgb8": (2, 8, struct.pack(">HHH", 1, 2, 3)),
        "rgb16": (2, 16, struct.pack(">HHH", 1, 2, 3)),
        "palette8": (3, 8, bytes(range(0, 256, 16))),
        "palette1": (3, 1, b"\x00")}


@pytest.mark.parametrize("name", TRNS)
def test_trns(tmp_path, jax_binding, name):
    """tRNS becomes alpha and alpha is dropped: the port's RGB bytes are
    the samples', whichever pixels the chunk names, as PIL's. The JAX
    binding reads RGBA rows as RGB (module docstring)."""
    color, depth, trns = TRNS[name]
    samples, palette = image(color, depth, 17, 33, seed=depth)
    data = png(samples, color, depth, palette=palette, trns=trns, filters=(1, 4))
    want = truth(samples, color, depth, palette)
    check(tmp_path, data, want, jax_binding,
          jax_trns_reading(want, trns_alpha(samples, color, trns)))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "I;16"])
def test_pil_written(tmp_path, jax_binding, mode):
    """PNGs as PIL writes them (its own filter choice and chunks; a
    palette image with transparency), as chip_smoke's ``[png]`` check
    writes them on the card."""
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (45, 70, 4), dtype=np.uint8)
    rgba[:, :35] = np.linspace(0, 255, 35, dtype=np.uint8)[None, :, None]
    im = Image.fromarray(rgba, "RGBA")
    if mode == "P":
        im = im.convert("RGB").quantize(colors=50)
        im.info["transparency"] = 3
    elif mode == "I;16":
        im = Image.fromarray((rgba[..., 0].astype(np.uint16) << 8) | rgba[..., 1])
    else:
        im = im.convert(mode)
    path = tmp_path / "pil.png"
    im.save(path, **({"transparency": 3} if mode == "P" else {}))
    want = pil_rgb(path)
    jax_want = None
    if mode == "P":             # PIL wrote a tRNS chunk: alpha 0 at index 3
        data = path.read_bytes()
        at = data.index(b"tRNS")
        trns = data[at + 4:at + 4 + struct.unpack(">I", data[at - 4:at])[0]]
        with Image.open(path) as p:
            idx = np.asarray(p)[..., None]
        jax_want = jax_trns_reading(want, trns_alpha(idx, 3, trns))
    check(tmp_path, path.read_bytes(), want, jax_binding, jax_want)


def corrupt(kind: str) -> bytes:
    samples, _ = image(2, 8, 17, 33)
    good = png(samples, 2, 8, filters=(0, 4))
    z = zlib.compress(scanlines(samples, 8, (0, 4)))
    head = good[:good.index(b"IDAT") - 4]
    if kind == "signature":
        return b"\x89PNG\r\n\x1a\x0b" + good[8:]
    if kind == "crc":
        at = good.index(b"IDAT") + 4 + len(z)        # the IDAT's CRC
        return good[:at] + bytes([good[at] ^ 1]) + good[at + 1:]
    if kind == "adler":
        return head + chunk(b"IDAT", z[:-1] + bytes([z[-1] ^ 1])) + chunk(b"IEND", b"")
    if kind == "truncated_idat":
        return head + chunk(b"IDAT", z[:len(z) // 2]) + chunk(b"IEND", b"")
    raise ValueError(kind)


@pytest.mark.parametrize("binding", ["port", "jax"])
@pytest.mark.parametrize("kind", ["crc", "adler", "truncated_idat", "signature"])
def test_corrupt_file_raises(tmp_path, jax_binding, kind, binding):
    path = tmp_path / f"{kind}.png"
    path.write_bytes(corrupt(kind))
    decode = pnative.decode_png if binding == "port" else jax_binding.decode_png
    with pytest.raises(IOError, match=f"{kind}.png"):
        decode(str(path))


def test_corrupt_cases_differ_from_a_good_file_only_where_named():
    """The corrupt files are the good file with one fault: a well-formed
    file decodes, and each fault is where its name says."""
    samples, _ = image(2, 8, 17, 33)
    good = png(samples, 2, 8, filters=(0, 4))
    with Image.open(io.BytesIO(good)) as im:
        np.testing.assert_array_equal(np.asarray(im), samples)
    z = zlib.compress(scanlines(samples, 8, (0, 4)))
    assert zlib.decompress(corrupt("crc")[good.index(b"IDAT") + 4:][:len(z)])
    with pytest.raises(zlib.error, match="incorrect data check"):
        zlib.decompress(z[:-1] + bytes([z[-1] ^ 1]))
    with pytest.raises(zlib.error):
        zlib.decompress(z[:len(z) // 2])


@pytest.mark.parametrize("color,depth", [(2, 8), (0, 1), (6, 16)])
def test_interlaced_raises_in_port(tmp_path, jax_binding, color, depth):
    """A valid Adam7 file (PIL reads it back as written) is refused."""
    samples, _ = image(color, depth, 17, 33)
    path = tmp_path / "adam7.png"
    path.write_bytes(png(samples, color, depth, filters=(1, 4), interlace=True))
    np.testing.assert_array_equal(pil_rgb(path), truth(samples, color, depth))
    with pytest.raises(IOError, match="adam7.png"):
        pnative.decode_png(str(path))


class BitWriter:
    """Deflate's bit order: fields LSB first, Huffman codes MSB first."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> None:
        self.bits += [(value >> i) & 1 for i in range(n)]

    def code(self, code: int, n: int) -> None:
        self.bits += [(code >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self) -> bytes:
        b = self.bits + [0] * (-len(self.bits) % 8)
        return np.packbits(np.array(b, np.uint8).reshape(-1, 8)[:, ::-1]).tobytes()


def canonical(lens):
    """RFC 1951's codes for code lengths ``lens`` (0: no code)."""
    count = [0] * 16
    for x in lens:
        count[x] += 1
    count[0], code, first = 0, 0, [0] * 16
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1
        first[n] = code
    codes = {}
    for sym, x in enumerate(lens):
        if x:
            codes[sym] = first[x]
            first[x] += 1
    return codes


def dynamic_zlib(data: bytes, lit_lens, dist_lens) -> bytes:
    """One final dynamic-Huffman block of literals only, with the given
    literal/length and distance code lengths (each length sent as a 4-bit
    code of a complete code-length code)."""
    w = BitWriter()
    w.put(1, 1)
    w.put(2, 2)
    w.put(len(lit_lens) - 257, 5)
    w.put(len(dist_lens) - 1, 5)
    w.put(19 - 4, 4)
    order = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
    for sym in order:                   # 0-15 at 4 bits: complete
        w.put(4 if sym < 16 else 0, 3)
    cl = canonical([4] * 16)
    for x in list(lit_lens) + list(dist_lens):
        w.code(cl[x], 4)
    lit = canonical(lit_lens)
    for b in data:
        w.code(lit[b], lit_lens[b])
    if 256 in lit:
        w.code(lit[256], lit_lens[256])
    return (b"\x78\x01" + w.bytes()
            + struct.pack(">I", zlib.adler32(data)))


def rule_cases():
    """(name, file, decodes): files that probe where libpng, as the JAX
    reader drives it, refuses or reads on; both bindings must agree."""
    samples, _ = image(2, 8, 17, 33)
    good = png(samples, 2, 8)
    raw = scanlines(samples, 8, (0,))
    head = good[:good.index(b"IDAT") - 4]
    iend = chunk(b"IEND", b"")
    text = good.index(b"tEXt") + 4
    text_crc = text + struct.unpack(">I", good[text - 8:text - 4])[0]
    z = zlib.compress(raw)
    pal_samples, _ = image(3, 8, 17, 33)
    nine = [9] * 256
    dyn = [
        # literals at 9 bits (1/2) and end-of-block at 1 bit: complete
        ("dynamic_complete", nine + [1], [0], True),
        # one distance code of 1 bit: incomplete, which zlib allows
        ("dynamic_one_distance_code", nine + [1], [1], True),
        # literals and end-of-block at 9 bits: 257/512, incomplete
        ("dynamic_incomplete_literals", nine + [9], [0], False),
        # literals and end-of-block at 8 bits: 257/256, over-subscribed
        ("dynamic_oversubscribed", [8] * 257, [0], False),
        # no end-of-block code
        ("dynamic_no_end_of_block", nine + [0] + [1], [0], False),
    ]
    dyn = [(name, head + chunk(b"IDAT", dynamic_zlib(raw, lit, dist)) + iend, ok)
           for name, lit, dist, ok in dyn]
    return dyn + [
        ("ancillary_bad_crc", good[:text_crc] + bytes([good[text_crc] ^ 1])
         + good[text_crc + 1:], True),
        ("no_iend", good[:good.index(b"IEND") - 4], True),
        ("bytes_after_idat", good[:good.index(b"IEND") - 4] + b"tail", True),
        ("bad_iend_crc", good[:-1] + bytes([good[-1] ^ 1]), True),
        ("extra_image_data", head + chunk(b"IDAT", zlib.compress(raw + b"x" * 50))
         + iend, True),
        ("empty_idat_first", head + chunk(b"IDAT", b"") + chunk(b"IDAT", z) + iend,
         True),
        ("palette_index_past_plte",     # libpng's palette is 256 zeroed entries
         png(pal_samples, 3, 8, palette=np.arange(12).reshape(4, 3) * 20), True),
        ("bad_ihdr_crc", good[:29] + bytes([good[29] ^ 1]) + good[30:], False),
        ("unknown_critical_chunk", good[:text - 8] + chunk(b"ABCD", b"xx")
         + good[text - 8:], False),
        ("chunk_before_ihdr", SIG + chunk(b"tEXt", b"a\x00b") + good[8:], False),
        ("filter_type_5", head + chunk(b"IDAT", zlib.compress(b"\x05" + raw[1:]))
         + iend, False),
        ("short_image_data", head + chunk(b"IDAT", zlib.compress(raw[:-5])) + iend,
         False),
        ("idat_run_broken", head + chunk(b"IDAT", z[:10]) + chunk(b"tEXt", b"a\x00b")
         + chunk(b"IDAT", z[10:]) + iend, False),
    ]


@pytest.mark.parametrize("case", range(len(rule_cases())),
                         ids=[c[0] for c in rule_cases()])
def test_libpng_rules(tmp_path, jax_binding, case):
    name, data, decodes = rule_cases()[case]
    path = tmp_path / f"{name}.png"
    path.write_bytes(data)
    if decodes:
        np.testing.assert_array_equal(pnative.decode_png(str(path)),
                                      jax_binding.decode_png(str(path)))
    else:
        for decode in (pnative.decode_png, jax_binding.decode_png):
            with pytest.raises(IOError, match=f"{name}.png"):
                decode(str(path))


def mutated(rng, it):
    """A small PNG whose zlib stream has 1-3 bits flipped anywhere or in
    its last 6 bytes, is cut short, or has bytes appended; the IDAT's CRC
    is right, so only the stream is at fault."""
    color = int(rng.choice(list(DEPTHS)))
    depth = int(rng.choice(DEPTHS[color]))
    samples, palette = image(color, depth, int(rng.integers(1, 20)),
                             int(rng.integers(1, 40)), seed=it)
    raw = scanlines(samples, depth, tuple(int(f) for f in rng.integers(0, 5, 3)))
    z = bytearray(zlib.compress(raw, int(rng.integers(0, 10))))
    kind = int(rng.integers(0, 4))
    if kind < 2:
        lo = 0 if kind == 0 else max(0, len(z) - 6)
        for _ in range(int(rng.integers(1, 4))):
            z[int(rng.integers(lo, len(z)))] ^= 1 << int(rng.integers(0, 8))
    elif kind == 2:
        z = z[:int(rng.integers(0, len(z)))]
    else:
        z += bytes(rng.integers(0, 256, int(rng.integers(1, 9)), dtype=np.uint8))
    h, w, _ = samples.shape
    out = SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", bytes(z)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("seed", range(4))
def test_mutated_streams_agree_with_libpng(tmp_path, jax_binding, seed):
    """150 mutated streams a seed: the port refuses exactly those libpng
    refuses and decodes the rest to libpng's bytes. libpng inflates a row
    a call and only warns on a fault found after the last row, so a
    fault in the stream's tail can decode in both."""
    rng = np.random.default_rng(seed)
    path = tmp_path / "m.png"
    outcomes = []
    for it in range(150):
        path.write_bytes(mutated(rng, it))
        got = []
        for decode in (pnative.decode_png, jax_binding.decode_png):
            try:
                got.append(decode(str(path)))
            except IOError:
                got.append(None)
        assert (got[0] is None) == (got[1] is None), f"file {it}: {got}"
        if got[0] is not None:
            np.testing.assert_array_equal(got[0], got[1])
        outcomes.append(got[0] is None)
    assert any(outcomes) and not all(outcomes)


def test_bench_png_record(tmp_path, jax_binding):
    """``tools/bench_png.py`` at a small size: the port, PIL and the JAX
    package's libpng build (``--against``) decode its frames bit-equal;
    every time finite and > 0; the record written as printed."""
    from video_super_resolution_tpu_torch.tools import bench_png

    lines = []
    out = tmp_path / "png.json"
    rec = bench_png.run(frames=2, h=40, w=56, reps=1, against=jnative._LIB_PATH,
                        root=str(tmp_path / "frames"), out=str(out),
                        emit=lines.append)
    assert rec["equal"] is True and set(rec["ms_per_frame"]) == {
        "port", "pil", "against"}
    assert all(np.isfinite(v) and v > 0 for v in rec["ms_per_frame"].values())
    assert bench_png.json.loads(lines[0]) == rec == bench_png.json.loads(
        out.read_text())
    assert bench_png.main(["--frames", "1", "--h", "8", "--w", "8", "--reps",
                           "1", "--root", str(tmp_path / "f2")]) == 0
