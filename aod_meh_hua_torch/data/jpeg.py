"""Baseline JPEG decoder in numpy: the port's counterpart of
`cv2.imread(path, cv2.IMREAD_COLOR)`, which aod_meh_hua_tpu/data/
pipeline.py:59-66 calls to load every VOC image.

The machine with the card has neither OpenCV nor PIL, so the port reads
JPEGs itself, bit for bit as OpenCV does. OpenCV decodes through
libjpeg-turbo, and this module follows that library's arithmetic:

* the `islow` integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2, the
  post-IDCT range-limit table of jdmaster.c);
* "fancy" triangular upsampling of the chroma planes (jdsample.c h2v1 and
  h2v2, with their +1/+2 and +8/+7 rounding biases; edge columns and
  rows are replicated as jdmainct.c does);
* YCbCr -> RGB with the fixed-point tables of jdcolor.c (SCALEBITS 16).

libjpeg-turbo keeps its SIMD paths bit-equal to this C arithmetic.

What it reads: SOI, APPn (skipped, except the EXIF orientation in APP1,
which it applies as cv2.imread does), DQT (8- and 16-bit tables),
SOF0/SOF1 with 8-bit samples, DHT, DRI with RSTn markers, SOS, COM, EOI;
one or three components, the luma sampled 1x1, 2x1 or 2x2 against 1x1
chroma; interleaved or single-component scans. Anything else
(progressive or lossless frames, arithmetic coding, 12-bit samples, four
components, Adobe RGB/CMYK transforms, 4:1:1 or 4:4:0 sampling, corrupt
entropy data) raises ValueError naming the file and the feature.

Output: uint8 BGR [H, W, 3], as cv2 returns; a greyscale JPEG comes back
with three equal channels, as IMREAD_COLOR gives it.

The Huffman decoding is a Python loop over a table of every 32-bit
window of the scan, one lookup per code; the IDCT, the upsampling and the
colour conversion run on all blocks at once in numpy.
"""

from __future__ import annotations

import array
import functools
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# natural (row-major) index of the k-th zig-zag coefficient (jutils.c)
_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)
# AC decoding runs k past 63 on a (corrupt) run; pad the table so that
# indexing never fails there and the check after the block catches it
_ZZ_PADDED = _ZIGZAG + (0,) * 80

_RST = re.compile(rb"\xff[\xd0-\xd7]")

_SOF_NAMES = {
    0xC2: "progressive DCT (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)", 0xC9: "arithmetic coding (SOF9)",
    0xCA: "progressive arithmetic coding (SOF10)", 0xCB: "lossless arithmetic (SOF11)",
    0xCD: "differential arithmetic (SOF13)", 0xCE: "differential progressive arithmetic (SOF14)",
    0xCF: "differential lossless arithmetic (SOF15)",
}


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "width", "height", "coef")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq


class _Frame:
    def __init__(self):
        self.qt: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, List[tuple]] = {}  # Huffman lookups (_huffman_lut)
        self.ac: Dict[int, List[tuple]] = {}
        self.restart = 0
        self.width = self.height = 0
        self.comps: List[_Component] = []
        self.hmax = self.vmax = 1
        self.mcux = self.mcuy = 0
        self.orientation = 1
        self.jfif = False
        self.adobe_transform: Optional[int] = None


def _fail(name: str, what: str):
    raise ValueError(f"{name}: {what}")


# AC lookup entries (t, r, v): t > 0 is the code's length plus its value
# bits, fully decoded; r is the run before the coefficient v, 16 for ZRL
# (v = 0) and _EOB for end-of-block. t = 0 leaves the value bits to the
# slow path: r is then the code length and v the symbol, -1 for no code.
_EOB = 1000


def _extend(bits: np.ndarray, s: np.ndarray) -> np.ndarray:
    """JPEG's EXTEND: s-bit magnitude categories to signed values."""
    return np.where(bits < (1 << np.maximum(s - 1, 0)), bits - (1 << s) + 1, bits)


@functools.lru_cache(maxsize=32)
def _huffman_lut(counts: bytes, symbols: bytes, ac: bool) -> List[tuple]:
    """Canonical Huffman table -> a 2^16-entry list indexed by the next 16
    bits of the stream (see _EOB for the AC entries; a DC entry is (t, v),
    v the decoded difference, or (0, length, symbol) for the slow path)."""
    length = np.zeros(65536, np.int64)
    sym = np.full(65536, -1, np.int64)
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            if code >= (1 << ln):
                raise ValueError("bad Huffman table")
            lo, hi = code << (16 - ln), (code + 1) << (16 - ln)
            length[lo:hi], sym[lo:hi] = ln, symbols[k]
            code += 1
            k += 1
        code <<= 1
    x = np.arange(65536, dtype=np.int64)
    s = np.where(sym >= 0, sym & 15, 0) if ac else np.where(sym >= 0, sym, 0)
    total = length + s
    fast = (sym >= 0) & (total <= 16)
    bits = (x >> np.maximum(16 - total, 0)) & ((1 << s) - 1)
    v = np.where(s > 0, _extend(bits, s), 0)
    if ac:
        run = np.where(s > 0, sym >> 4, np.where(sym == 0xF0, 16, _EOB))
        t = np.where(fast, total, 0)
        r = np.where(fast, run, length)
        v = np.where(fast, v, sym)
        return list(zip(t.tolist(), r.tolist(), v.tolist()))
    t = np.where(fast, total, 0)
    v = np.where(fast, v, sym)
    return [(a, b) if a else (0, c, d) for a, b, c, d in
            zip(t.tolist(), v.tolist(), length.tolist(), sym.tolist())]


def _exif_orientation(payload: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in an APP1 Exif payload, 1
    when absent or unreadable."""
    tiff = payload[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    try:
        ifd = struct.unpack(end + "I", tiff[4:8])[0]
        n = struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]
        for i in range(n):
            e = ifd + 2 + 12 * i
            tag, typ = struct.unpack(end + "HH", tiff[e:e + 4])
            if tag == 0x0112 and typ == 3:
                return struct.unpack(end + "H", tiff[e + 8:e + 10])[0]
    except struct.error:
        return 1
    return 1


def _read_headers(data: bytes, name: str, stop_at_sof: bool = False):
    """Walk the markers. Returns (frame, [(scan components as (component
    index, DC table, AC table), entropy-coded bytes, restart interval)]),
    or, with stop_at_sof, the frame as soon as its SOF is read."""
    if data[:2] != b"\xff\xd8":
        _fail(name, "not a JPEG file (no SOI marker)")
    f = _Frame()
    scans = []
    pos, n = 2, len(data)
    seen_sof = False
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1  # tolerate garbage between segments, as libjpeg warns
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            _fail(name, "truncated file (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue  # TEM / stray RSTn carry no length
        if pos + 2 > n:
            _fail(name, "truncated segment")
        seg_len = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + seg_len]
        if len(seg) != seg_len - 2:
            _fail(name, "truncated segment")
        pos += seg_len
        if marker in (0xC0, 0xC1):
            if seen_sof:
                _fail(name, "more than one frame")
            seen_sof = True
            precision, f.height, f.width, nf = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                _fail(name, f"{precision}-bit samples (only 8-bit is read)")
            if f.height == 0:
                _fail(name, "height defined by a DNL marker")
            for i in range(nf):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                f.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            if stop_at_sof:
                return f, scans
        elif marker in _SOF_NAMES:
            _fail(name, _SOF_NAMES[marker])
        elif marker == 0xCC:
            _fail(name, "arithmetic coding (DAC)")
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = seg[p + 1:p + 17]
                total = sum(counts)
                try:
                    lut = _huffman_lut(bytes(counts), bytes(seg[p + 17:p + 17 + total]),
                                       bool(tc))
                except ValueError as e:
                    _fail(name, str(e))
                (f.ac if tc else f.dc)[th] = lut
                p += 17 + total
        elif marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                if pq:
                    vals = struct.unpack(">64H", seg[p + 1:p + 129])
                    p += 129
                else:
                    vals = tuple(seg[p + 1:p + 65])
                    p += 65
                q = np.zeros(64, np.int64)
                q[list(_ZIGZAG)] = vals  # the file lists them in zig-zag order
                f.qt[tq] = q
        elif marker == 0xDD:  # DRI
            f.restart = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:  # SOS
            if not seen_sof:
                _fail(name, "scan before frame header")
            ns = seg[0]
            ids = [c.cid for c in f.comps]
            sel = []
            for i in range(ns):
                cs, tdta = seg[1 + 2 * i], seg[2 + 2 * i]
                if cs not in ids:
                    _fail(name, f"scan names unknown component {cs}")
                sel.append((ids.index(cs), tdta >> 4, tdta & 15))
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                _fail(name, "spectral selection or successive approximation in a "
                            "baseline scan")
            # entropy-coded data runs to the next marker that is not RSTn
            start = pos
            while True:
                pos = data.find(b"\xff", pos)
                if pos < 0 or pos + 1 >= n:
                    _fail(name, "truncated scan")
                nxt = data[pos + 1]
                if nxt == 0x00 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
                    pos += 1 if nxt == 0xFF else 2
                    continue
                break
            scans.append((sel, data[start:pos], f.restart))
        elif marker == 0xE1 and seg[:6] == b"Exif\x00\x00":
            if f.orientation == 1:
                f.orientation = _exif_orientation(seg)
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            f.jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            f.adobe_transform = seg[11]
        elif marker == 0xDC:
            _fail(name, "DNL marker")
        # other APPn, COM: skipped
    if not seen_sof:
        _fail(name, "no frame header (SOF)")
    return f, scans


def _check_frame(f: _Frame, name: str) -> None:
    nf = len(f.comps)
    if nf == 3:
        if f.adobe_transform == 0 and not f.jfif:
            _fail(name, "Adobe transform 0 (RGB components)")
        if f.adobe_transform not in (None, 1) and not f.jfif:
            _fail(name, f"Adobe transform {f.adobe_transform}")
        if not f.jfif and f.adobe_transform is None and \
                [c.cid for c in f.comps] == [82, 71, 66]:
            _fail(name, "RGB components ('R', 'G', 'B' ids)")
        y, cb, cr = f.comps
        if (cb.h, cb.v, cr.h, cr.v) != (1, 1, 1, 1) or (y.h, y.v) not in ((1, 1), (2, 1), (2, 2)):
            _fail(name, "sampling factors "
                  + ",".join(f"{c.h}x{c.v}" for c in f.comps)
                  + " (only 1x1, 2x1 and 2x2 luma over 1x1 chroma are read)")
    elif nf == 1:
        f.comps[0].h = f.comps[0].v = 1  # one component: no subsampling
    else:
        _fail(name, f"{nf} components (CMYK/YCCK or other; only 1 or 3 are read)")
    f.hmax = max(c.h for c in f.comps)
    f.vmax = max(c.v for c in f.comps)
    f.mcux = -(-f.width // (8 * f.hmax))
    f.mcuy = -(-f.height // (8 * f.vmax))
    for c in f.comps:
        if c.tq not in f.qt:
            _fail(name, f"missing quantization table {c.tq}")
        c.width = -(-f.width * c.h // f.hmax)
        c.height = -(-f.height * c.v // f.vmax)
        c.bw, c.bh = f.mcux * c.h, f.mcuy * c.v
        c.coef = array.array("i", [0]) * (c.bw * c.bh * 64)


def _unstuff(seg: bytes) -> bytes:
    return seg.replace(b"\xff\x00", b"\xff")


def _windows(data: bytes) -> array.array:
    """win[p] = the 32 bits of `data` that start at bit p (zeros past the
    end, as libjpeg fills the bit buffer at a marker), 64 spare entries
    past the end."""
    n = len(data)
    b = np.frombuffer(data + b"\x00" * 8, np.uint8)
    # the 64 bits from each byte, big-endian: bytes i..i+7
    v = np.zeros(n, np.uint64)
    for j in range(8):
        v = (v << np.uint64(8)) | b[j:n + j]
    shifts = np.arange(32, 24, -1, dtype=np.uint64)
    win = ((v[:, None] >> shifts) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out = array.array("I", win.tobytes())
    out.extend([0] * 64)
    return out


def _scan_blocks(f: _Frame, sel) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """The scan's MCUs in coding order, each a tuple of its blocks as
    (component index, coefficient offset of the block in that component's
    array). A single-component scan codes one block per MCU over the
    component's own extent; an interleaved scan codes h x v blocks of each
    component per MCU."""
    comps = tuple((ci, f.comps[ci].h, f.comps[ci].v, f.comps[ci].bw,
                   f.comps[ci].width, f.comps[ci].height) for ci, _, _ in sel)
    return _mcu_layout(f.mcux, f.mcuy, comps)


@functools.lru_cache(maxsize=64)
def _mcu_layout(mcux: int, mcuy: int, comps) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    if len(comps) == 1:
        ci, _, _, bw, width, height = comps[0]
        return tuple(((ci, (by * bw + bx) * 64),)
                     for by in range(-(-height // 8)) for bx in range(-(-width // 8)))
    mcus = []
    for my in range(mcuy):
        for mx in range(mcux):
            mcus.append(tuple((ci, ((my * v + dv) * bw + mx * h + dh) * 64)
                              for ci, h, v, bw, _, _ in comps
                              for dv in range(v) for dh in range(h)))
    return tuple(mcus)


def _decode_scan(f: _Frame, sel, data: bytes, restart: int, name: str) -> None:
    """Huffman-decode one scan into the components' coefficient arrays
    (natural order, not yet dequantized)."""
    mcus = _scan_blocks(f, sel)
    tables = {}
    for ci, td, ta in sel:
        if td not in f.dc or ta not in f.ac:
            _fail(name, f"missing Huffman table for component {f.comps[ci].cid}")
        tables[ci] = (f.dc[td], f.ac[ta], f.comps[ci].coef)
    # split at the restart markers: each interval starts byte-aligned with
    # the DC predictions reset
    if restart:
        parts, step = _RST.split(data), restart
    else:
        parts, step = [data], len(mcus)
    zz = _ZZ_PADDED
    for ip, part in enumerate(parts):
        lo = ip * step
        if lo >= len(mcus):
            break
        win = _windows(_unstuff(part))
        limit = len(win) - 64
        pos = 0
        pred = [0] * len(f.comps)
        for mcu in mcus[lo:lo + step]:
            for ci, base in mcu:
                dc, ac, coef = tables[ci]
                e = dc[win[pos] >> 16]
                if e[0]:
                    pos += e[0]
                    pred[ci] += e[1]
                else:
                    _, ln, s = e
                    if s < 0:
                        _fail(name, "corrupt entropy-coded data (bad DC code)")
                    v = (win[pos] >> (32 - ln - s)) & ((1 << s) - 1)
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    pred[ci] += v
                    pos += ln + s
                coef[base] = pred[ci]
                k = 1
                while k < 64:
                    t, r, v = ac[win[pos] >> 16]
                    if t:
                        pos += t
                        k += r
                        if v:
                            coef[base + zz[k]] = v
                            k += 1
                        continue
                    # the code and its value bits exceed 16 bits
                    if v < 0:
                        _fail(name, "corrupt entropy-coded data (bad AC code)")
                    s = v & 15
                    k += v >> 4
                    v = (win[pos] >> (32 - r - s)) & ((1 << s) - 1)
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    coef[base + zz[k]] = v
                    pos += r + s
                    k += 1
                if 64 < k < _EOB:
                    _fail(name, "corrupt entropy-coded data (AC run past 63)")
            if pos > limit:
                _fail(name, "corrupt entropy-coded data (scan overrun)")


# jidctint.c constants, FIX(x) = round(x * 2^13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x, shift: int):
    """One pass of jpeg_idct_islow along the last axis of x [..., 8]
    (int64), descaled by `shift` with rounding; returns [..., 8]."""
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[..., 0] + x[..., 4]) << 13
    tmp1 = (x[..., 0] - x[..., 4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=-1)
    return (out + (1 << (shift - 1))) >> shift


def _range_limit_table() -> np.ndarray:
    """IDCT_range_limit (jdmaster.c prepare_range_limit_table), indexed by
    x & 1023 for an IDCT output x: clamp(x + 128) within the range and a
    wrap beyond it."""
    m = np.arange(1024)
    out = np.where(m < 128, m + 128, 255)
    out = np.where(m >= 512, 0, out)
    out = np.where(m >= 896, m - 896, out)
    return out.astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized blocks [n, 8, 8] (int64, natural order) -> samples
    [n, 8, 8] uint8: columns first (PASS1_BITS 2), then rows."""
    ws = _idct_1d(coef.transpose(0, 2, 1), 13 - 2).transpose(0, 2, 1)
    out = _idct_1d(ws, 13 + 2 + 3)
    return _RANGE_LIMIT[out & 1023]


def _plane(f: _Frame, c: _Component) -> np.ndarray:
    """A component's samples [height, width] uint8."""
    blocks = np.frombuffer(c.coef, np.int32).reshape(-1, 64) * f.qt[c.tq][None, :]
    px = _idct_islow(blocks.reshape(-1, 8, 8)).reshape(c.bh, c.bw, 8, 8)
    return px.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)[:c.height, :c.width]


def _fancy_h2(x: np.ndarray, bias_lo: int, bias_hi: int, shift: int) -> np.ndarray:
    """Horizontal 2x triangular upsampling of x [h, w] (int32): out[2i] =
    (3 x[i] + x[i-1] + bias_lo) >> shift, out[2i+1] = (3 x[i] + x[i+1] +
    bias_hi) >> shift, the edge columns replicated (jdsample.c)."""
    p = np.pad(x, ((0, 0), (1, 1)), mode="edge")
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + p[:, :-2] + bias_lo) >> shift
    out[:, 1::2] = (3 * x + p[:, 2:] + bias_hi) >> shift
    return out


def _upsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """Upsample a chroma plane by (h, v) in {(1,1), (2,1), (2,2)} with
    libjpeg's fancy upsampling (box replication below 3 columns, as
    jinit_upsampler falls back)."""
    if (h, v) == (1, 1):
        return plane
    x = plane.astype(np.int32)
    if x.shape[1] <= 2:
        return np.repeat(np.repeat(plane, h, axis=1), v, axis=0)
    if v == 1:
        return _fancy_h2(x, 1, 2, 2).astype(np.uint8)
    p = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    rows = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    rows[0::2] = 3 * x + p[:-2]   # nearer row, then the row above
    rows[1::2] = 3 * x + p[2:]    # nearer row, then the row below
    return _fancy_h2(rows, 8, 7, 4).astype(np.uint8)


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table: Cr->R, Cb->B, and the green offset
    (Cb_g[cb] + Cr_g[cr]) >> 16 for every (cb, cr) pair."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    g = (cb_g[:, None] + cr_g[None, :]) >> 16
    return cr_r.astype(np.int32), cb_b.astype(np.int32), g.astype(np.int32)


_CR_R, _CB_B, _G_CB_CR = _ycc_tables()
# range_limit of jdmaster.c over the reach of y + the table terms
_CLAMP = np.clip(np.arange(-512, 768), 0, 255).astype(np.uint8)


def _ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    y = y.astype(np.int32) + 512
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _CLAMP[y + _CB_B[cb]]
    out[..., 1] = _CLAMP[y + _G_CB_CR[cb, cr]]
    out[..., 2] = _CLAMP[y + _CR_R[cr]]
    return out


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """Apply an EXIF orientation as OpenCV's ExifTransform does."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 BGR [H, W, 3], bit-equal to cv2.imdecode(...,
    IMREAD_COLOR). Raises ValueError for what it does not read."""
    f, scans = _read_headers(bytes(data), name)
    _check_frame(f, name)
    if not scans:
        _fail(name, "no scan")
    for sel, seg, restart in scans:
        _decode_scan(f, sel, seg, restart, name)
    planes = [_plane(f, c) for c in f.comps]
    if len(planes) == 1:
        img = np.repeat(planes[0][:, :, None], 3, axis=2)
    else:
        y = planes[0]
        hy, vy = f.comps[0].h, f.comps[0].v
        # the chroma planes upsample to the luma's sampling, then all crop
        cb = _upsample(planes[1], hy, vy)[:f.height, :f.width]
        cr = _upsample(planes[2], hy, vy)[:f.height, :f.width]
        img = _ycc_to_bgr(y[:f.height, :f.width], cb, cr)
    return _orient(img, f.orientation)


def imread(path: str) -> np.ndarray:
    """Read a JPEG file as uint8 BGR [H, W, 3] (cv2.imread IMREAD_COLOR)."""
    with open(path, "rb") as fh:
        data = fh.read()
    return decode(data, path)


def jpeg_size(path: str) -> Tuple[int, int]:
    """(width, height) from the frame header, as PIL's Image.size reads it
    (without the EXIF orientation)."""
    with open(path, "rb") as fh:
        data = fh.read()
    f, _ = _read_headers(data, path, stop_at_sof=True)
    return f.width, f.height
