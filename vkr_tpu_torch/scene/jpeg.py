"""Huffman-coded JPEG -> RGBA8, as PIL's Image.open(...).convert("RGBA")
gives it over libjpeg-turbo, in numpy alone (the card's machine has no
PIL).

vkr_tpu decodes glTF images with PIL (vkr_tpu/scene/gltf.py:117-122), and
PIL decodes JPEG with libjpeg-turbo's defaults. Where libjpeg-turbo and
the JPEG specification leave room, this module follows libjpeg-turbo:

  * entropy decoding of SOF0 (baseline), SOF1 (extended Huffman, 8-bit
    and 16-bit DQT) and SOF2 (progressive: DC first and refine, AC first
    with EOB runs, AC refine), restart intervals, interleaved and
    non-interleaved scans (a non-interleaved scan covers ceil(component
    width / 8) blocks, not the MCU-padded count);
  * the integer "islow" IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2),
    its output through the post-IDCT range-limit table (index & 1023), so
    overflowing blocks wrap as the table says;
  * "fancy" upsampling (jdsample.c: h2v1, h2v2, h1v2; box replication
    where libjpeg-turbo takes it), with the last real column and row of
    the downsampled component as their own neighbours;
  * YCbCr -> RGB through jdcolor.c's tables (SCALEBITS 16);
  * no block smoothing: libjpeg-turbo smooths a progressive image only
    while coefficients are missing (jdcoefct.c:smoothing_ok), and PIL
    reads the whole file before it outputs a row;
  * CMYK with PIL's reading of it: the samples inverted (rawmode
    "CMYK;I") and converted with Pillow's cmyk2rgb.

The entropy decoder is the one serial part: a Python loop over a bit
window with a 16-bit lookup per Huffman code. Byte unstuffing and the
split at restart markers are done up front with numpy; dequantisation,
IDCT, upsampling and colour conversion work on whole arrays.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

_UNPORTED = "ROADMAP queue 1 item 18"

# jpeg_natural_order: zigzag index -> natural (row-major) index, with
# libjpeg's 16 extra entries of 63 for runs past the end of a block
_NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

_SOF_OTHER = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical (SOF14)",
    0xCF: "arithmetic-coded hierarchical (SOF15)",
}


class _Component:
    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None      # latched quantisation table, natural order
        self.offset = 0     # first coefficient in the flat list
        self.bw = self.bh = 0  # blocks across and down, MCU-padded
        self.dw = self.dh = 0  # samples across and down (downsampled)


class _Frame:
    """A frame header's geometry and the flat coefficient list of all its
    components (component after component, blocks row-major, 64 natural-
    order coefficients each)."""

    def __init__(self, payload, marker):
        if marker in _SOF_OTHER:
            raise NotImplementedError(
                f"{_SOF_OTHER[marker]} JPEG is not ported ({_UNPORTED})")
        precision, self.h, self.w, n = struct.unpack(">BHHB", payload[:6])
        if precision != 8:
            raise NotImplementedError(
                f"{precision}-bit JPEG is not ported ({_UNPORTED})")
        if self.h == 0:
            raise NotImplementedError(
                f"JPEG with its height in a DNL marker is not ported "
                f"({_UNPORTED})")
        self.progressive = marker == 0xC2
        self.comps = [_Component(payload[6 + 3 * i], payload[7 + 3 * i] >> 4,
                                 payload[7 + 3 * i] & 15, payload[8 + 3 * i])
                      for i in range(n)]
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        total = 0
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise ValueError("JPEG with fractional sampling factors")
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.dw = -(-self.w * c.h // self.hmax)
            c.dh = -(-self.h * c.v // self.vmax)
            c.offset = total
            total += c.bw * c.bh * 64
        self.coef = [0] * total


def _huffman_table(counts, symbols) -> List[int]:
    """The 65,536-entry lookup of a DHT table: the next 16 bits of the
    stream -> (symbol << 5) | code length. Codes that the table does not
    assign read as symbol 0 of length 16 (libjpeg warns and does the
    same)."""
    table = np.full(1 << 16, 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (
                (symbols[k] << 5) | length)
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _entropy_end(buf: np.ndarray, start: int) -> int:
    """Index of the marker that ends the entropy-coded data at start: the
    first 0xFF followed by neither 0x00 (a stuffed byte) nor RST0-7."""
    ff = np.flatnonzero(buf[start:-1] == 0xFF) + start
    nxt = buf[ff + 1]
    ends = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7))]
    return int(ends[0]) if len(ends) else len(buf)


def _segments(buf: np.ndarray, start: int, end: int) -> List[List[int]]:
    """The entropy-coded data between start and end, split at its RST
    markers and unstuffed (0xFF 0x00 -> 0xFF), each segment as its list
    of 32-bit big-endian windows: window i holds bytes i..i+3, zeros past
    the end (libjpeg feeds zero bits past a marker)."""
    data = buf[start:end]
    ff = np.flatnonzero(data[:-1] == 0xFF)
    nxt = data[ff + 1]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    stuffed = ff[nxt == 0] + 1
    keep = np.ones(len(data), bool)
    keep[stuffed] = False
    keep[rst] = keep[rst + 1] = False
    bounds = [0, *(rst + 2).tolist(), len(data)]
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        seg = data[a:b][keep[a:b]].astype(np.int64)
        seg = np.concatenate([seg, np.zeros(8, np.int64)])
        out.append(((seg[:-3] << 24) | (seg[1:-2] << 16) | (seg[2:-1] << 8)
                    | seg[3:]).tolist())
    return out


# ------------------------------------------------------- entropy decoders
# Each decodes one restart segment: blocks is a list of (coefficient
# base, component slot, DC table, AC table), coef the flat coefficient
# list. A bit position p reads win[p >> 3]; the next 16 bits are
# (win >> (16 - (p & 7))) & 0xFFFF, the next s bits (s <= 16)
# (win >> (32 - (p & 7) - s)) & ((1 << s) - 1).

def _sequential(win, blocks, coef, _ss, _se, _al, n_slots):
    nat = _NATURAL
    pred = [0] * n_slots
    p = 0
    for base, c, dct, act in blocks:
        e = dct[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        p += e & 31
        s = e >> 5
        if s:
            v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            pred[c] += v
        coef[base] = pred[c]
        k = 1
        while k < 64:
            e = act[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += e & 31
            rs = e >> 5
            s = rs & 15
            if s:
                k += rs >> 4
                v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                coef[base + nat[k]] = v
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


def _dc_first(win, blocks, coef, _ss, _se, al, n_slots):
    pred = [0] * n_slots
    p = 0
    for base, c, dct, _ in blocks:
        e = dct[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        p += e & 31
        s = e >> 5
        if s:
            v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            pred[c] += v
        coef[base] = pred[c] << al


def _dc_refine(win, blocks, coef, _ss, _se, al, _n):
    p1 = 1 << al
    p = 0
    for base, _, _, _ in blocks:
        if (win[p >> 3] >> (31 - (p & 7))) & 1:
            coef[base] |= p1
        p += 1


def _ac_first(win, blocks, coef, ss, se, al, _n):
    nat = _NATURAL
    eobrun = 0
    p = 0
    for base, _, _, act in blocks:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = act[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += e & 31
            rs = e >> 5
            s = rs & 15
            r = rs >> 4
            if s:
                k += r
                v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                coef[base + nat[k]] = v << al
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & (
                        (1 << r) - 1)
                    p += r
                eobrun -= 1
                break
            k += 1


def _ac_refine(win, blocks, coef, ss, se, al, _n):
    """jdphuff.c:decode_mcu_AC_refine: new coefficients of magnitude
    1 << al, and one correction bit for each coefficient already nonzero
    that the run passes over."""
    nat = _NATURAL
    p1 = 1 << al
    m1 = -1 << al
    eobrun = 0
    p = 0
    for base, _, _, act in blocks:
        k = ss
        if not eobrun:
            while k <= se:
                e = act[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += e & 31
                rs = e >> 5
                s = rs & 15
                r = rs >> 4
                if s:
                    s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & (
                            (1 << r) - 1)
                        p += r
                    break
                while k <= se:
                    i = base + nat[k]
                    cv = coef[i]
                    if cv:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1 and not (
                                cv & p1):
                            coef[i] = cv + (p1 if cv >= 0 else m1)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    coef[base + nat[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = base + nat[k]
                cv = coef[i]
                if cv:
                    if (win[p >> 3] >> (31 - (p & 7))) & 1 and not (cv & p1):
                        coef[i] = cv + (p1 if cv >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1


# ------------------------------------------------------------------ IDCT

_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0_298=2446, f0_390=3196, f0_541=4433, f0_765=6270, f0_899=7373,
          f1_175=9633, f1_501=12299, f1_847=15137, f1_961=16069,
          f2_053=16819, f2_562=20995, f3_072=25172)


def _idct_1d(x, shift):
    """One jidctint.c pass on the 8 inputs x[0..7] (int64 arrays), each
    output DESCALEd by shift bits (rounded, arithmetic shift)."""
    f = _F
    z1 = (x[2] + x[6]) * f["f0_541"]
    tmp2 = z1 - x[6] * f["f1_847"]
    tmp3 = z1 + x[2] * f["f0_765"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1_175"]
    t0 = t0 * f["f0_298"]
    t1 = t1 * f["f2_053"]
    t2 = t2 * f["f3_072"]
    t3 = t3 * f["f1_501"]
    z1 = z1 * -f["f0_899"]
    z2 = z2 * -f["f2_562"]
    z3 = z3 * -f["f1_961"] + z5
    z4 = z4 * -f["f0_390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit_table() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by (s - 128) & 1023 for an
    IDCT sample s: s itself for 0 <= s <= 255, 255 for 256..639, 0 for
    640..1023 and for -384..-1; beyond those, s wraps by 1024."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0],
                     i - 896).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(N, 64) int16 coefficients (natural order) and their (64,)
    quantisation table -> (N, 8, 8) uint8 samples, jidctint.c's
    jpeg_idct_islow. Its shortcuts for all-zero AC columns and rows give
    what the full butterflies give, so every block takes the butterflies.
    The table is read as ISLOW_MULT_TYPE (short) and pass 1's results as
    int, as libjpeg-turbo stores them."""
    q = qt.astype(np.int16).astype(np.int64)
    d = coef.astype(np.int64).reshape(-1, 8, 8) * q.reshape(8, 8)
    cols = _idct_1d([d[:, k, :] for k in range(8)],
                    _CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, 1).astype(np.int32).astype(np.int64)
    rows = _idct_1d([ws[:, :, k] for k in range(8)],
                    _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE_LIMIT[np.stack(rows, 2) & 1023]


# ------------------------------------------------------------ upsampling

def _edge(a, axis, step):
    """a shifted by one along axis (step -1: the previous element, +1: the
    next), the edge element standing in for the one past the edge."""
    a = np.moveaxis(a, axis, 0)
    out = (np.concatenate([a[:1], a[:-1]]) if step < 0
           else np.concatenate([a[1:], a[-1:]]))
    return np.moveaxis(out, 0, axis)


def _interleave(even, odd, axis):
    out = np.stack([even, odd], axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, dw: int, dh: int, fh: int, fv: int
             ) -> np.ndarray:
    """jdsample.c on a decoded component plane: (dh, dw) real samples of
    the (padded) plane, expanded by fh along x and fv along y. Fancy
    (triangle) filters for 2x1 (when dw > 2), 2x2 (when dw > 2) and 1x2;
    box replication otherwise. Returns (dh * fv, dw * fh) uint8."""
    x = plane[:dh, :dw].astype(np.int32)
    if (fh, fv) == (1, 1):
        return x.astype(np.uint8)
    if (fh, fv) == (2, 1) and dw > 2:
        out = _interleave((3 * x + _edge(x, 1, -1) + 1) >> 2,
                          (3 * x + _edge(x, 1, 1) + 2) >> 2, 1)
    elif (fh, fv) == (1, 2):
        out = _interleave((3 * x + _edge(x, 0, -1) + 1) >> 2,
                          (3 * x + _edge(x, 0, 1) + 2) >> 2, 0)
    elif (fh, fv) == (2, 2) and dw > 2:
        sums = [3 * x + _edge(x, 0, -1), 3 * x + _edge(x, 0, 1)]
        rows = [_interleave((3 * c + _edge(c, 1, -1) + 8) >> 4,
                            (3 * c + _edge(c, 1, 1) + 7) >> 4, 1)
                for c in sums]
        out = _interleave(rows[0], rows[1], 0)
    else:
        out = np.repeat(np.repeat(x, fv, 0), fh, 1)
    return out.astype(np.uint8)


# -------------------------------------------------------------- colour

def _ycc_tables():
    """jdcolor.c:build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16,
            (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x,
            -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c:ycc_rgb_convert on uint8 planes -> (H, W, 3) uint8."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64)
    cr = cr.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb (Convert.c) on (H, W, 4) uint8: nk = 255 - k,
    each channel nk - MULDIV255(c, nk), clipped."""
    c = cmyk[..., :3].astype(np.int64)
    nk = 255 - cmyk[..., 3:].astype(np.int64)
    t = c * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# --------------------------------------------------------------- decoder

def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8, what PIL's convert("RGBA") gives."""
    buf = np.frombuffer(data, np.uint8)
    if bytes(data[:2]) != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    qtables: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    restart = 0
    jfif = False
    adobe = None
    frame = None
    pos = 2
    while pos < len(buf):
        if buf[pos] != 0xFF:
            raise ValueError(f"JPEG: no marker at byte {pos}")
        while pos < len(buf) and buf[pos] == 0xFF:
            pos += 1
        if pos >= len(buf):
            break
        marker = int(buf[pos])
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue
        length = int(buf[pos]) << 8 | int(buf[pos + 1])
        payload = bytes(buf[pos + 2:pos + length])
        pos += length
        if marker == 0xDB:
            i = 0
            while i < len(payload):
                pq, tq = payload[i] >> 4, payload[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(payload[i + 1:i + 1 + n],
                                     ">u2" if pq else np.uint8)
                qt = np.zeros(64, np.int64)
                qt[_NATURAL[:64]] = vals
                qtables[tq] = qt
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(payload):
                tc, th = payload[i] >> 4, payload[i] & 15
                counts = list(payload[i + 1:i + 17])
                symbols = list(payload[i + 17:i + 17 + sum(counts)])
                (ac_tabs if tc else dc_tabs)[th] = _huffman_table(
                    counts, symbols)
                i += 17 + sum(counts)
        elif marker == 0xDD:
            restart = struct.unpack(">H", payload[:2])[0]
        elif marker == 0xE0 and payload[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and payload[:5] == b"Adobe":
            adobe = payload[11] if len(payload) > 11 else 0
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise ValueError("JPEG with two frames")
            frame = _Frame(payload, marker)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            end = _entropy_end(buf, pos)
            _scan(frame, payload, _segments(buf, pos, end), restart,
                  qtables, dc_tabs, ac_tabs)
            pos = end
    if frame is None:
        raise ValueError("JPEG without a frame header")
    return _output(frame, jfif, adobe)


def _scan(frame, payload, segs, restart, qtables, dc_tabs, ac_tabs):
    """Decode one scan (its SOS payload and restart segments) into the
    frame's coefficients."""
    comps = frame.comps
    n = payload[0]
    scomps = []
    for i in range(n):
        cid, tables = payload[1 + 2 * i], payload[2 + 2 * i]
        comp = next((c for c in comps if c.cid == cid), None)
        if comp is None or (comp.qt is None and comp.tq not in qtables):
            raise ValueError(f"JPEG scan of component {cid}: no such "
                             "component or no quantisation table")
        if comp.qt is None:  # latched at the component's first scan
            comp.qt = qtables[comp.tq]
        scomps.append((comp, tables >> 4, tables & 15))
    ss, se, ahal = payload[1 + 2 * n:4 + 2 * n]
    ah, al = ahal >> 4, ahal & 15
    if not frame.progressive:
        decode, ss, se, al = _sequential, 0, 63, 0
    elif ss == 0:
        decode = _dc_refine if ah else _dc_first
    else:
        decode = _ac_refine if ah else _ac_first

    # blocks in scan order: (MCUs, blocks per MCU) coefficient bases
    if n == 1:
        comp = scomps[0][0]
        by, bx = np.mgrid[0:-(-comp.dh // 8), 0:-(-comp.dw // 8)]
        bases = comp.offset + (by * comp.bw + bx).reshape(-1, 1) * 64
        slots = [0]
    else:
        my, mx = np.mgrid[0:frame.mcuy, 0:frame.mcux]
        my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
        cols, slots = [], []
        for slot, (comp, _, _) in enumerate(scomps):
            v, hh = np.mgrid[0:comp.v, 0:comp.h]
            blk = ((my * comp.v + v.reshape(1, -1)) * comp.bw
                   + mx * comp.h + hh.reshape(1, -1))
            cols.append(comp.offset + blk * 64)
            slots += [slot] * (comp.v * comp.h)
        bases = np.concatenate(cols, 1)
    per_mcu = len(slots)
    tables = []
    for _, td, ta in scomps:
        dc = dc_tabs.get(td) if decode in (_sequential, _dc_first) else []
        ac = ac_tabs.get(ta) if decode not in (_dc_first, _dc_refine) else []
        if dc is None or ac is None:
            raise ValueError("JPEG scan names an undefined Huffman table")
        tables.append((dc, ac))
    blocks = [(b, s) + tables[s] for b, s in zip(
        bases.ravel().tolist(), slots * len(bases))]

    mcus = len(blocks) // per_mcu
    step = restart if restart else mcus
    for win, m0 in zip(segs, range(0, mcus, step)):
        decode(win, blocks[m0 * per_mcu:(m0 + step) * per_mcu], frame.coef,
               ss, se, al, len(scomps))


def _output(frame, jfif, adobe) -> np.ndarray:
    """IDCT, upsampling and colour conversion of the decoded frame."""
    h, w = frame.h, frame.w
    comps = frame.comps
    flat = np.array(frame.coef, np.int64).astype(np.int16)
    planes = []
    for c in comps:
        if c.qt is None:
            raise ValueError(f"JPEG component {c.cid} has no scan")
        n = c.bw * c.bh
        blocks = idct_islow(flat[c.offset:c.offset + n * 64].reshape(n, 64),
                            c.qt)
        plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.bh * 8, c.bw * 8)
        full = upsample(plane, c.dw, c.dh, frame.hmax // c.h,
                        frame.vmax // c.v)
        planes.append(full[:h, :w])
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if len(comps) == 1:
        out[..., :3] = planes[0][..., None]
    elif len(comps) == 3:
        ids = tuple(c.cid for c in comps)
        rgb = (not jfif and ((adobe is not None and adobe == 0)
                             or (adobe is None and ids == (82, 71, 66))))
        out[..., :3] = (np.stack(planes, -1) if rgb
                        else ycc_to_rgb(*planes))
    elif len(comps) == 4:
        if adobe is not None and adobe != 0:
            raise NotImplementedError(
                f"YCCK JPEG is not ported ({_UNPORTED})")
        out[..., :3] = cmyk_to_rgb(255 - np.stack(planes, -1))
    else:
        raise ValueError(f"JPEG with {len(comps)} components")
    return out
