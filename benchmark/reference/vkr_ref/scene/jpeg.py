"""JPEG -> RGBA8, as PIL's Image.open(...).convert("RGBA") gives it over
libjpeg-turbo, in numpy alone (the card's machine has no PIL).

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
    "CMYK;I") and converted with Pillow's cmyk2rgb; YCCK (Adobe transform
    other than 0) first through jdcolor.c's ycck_cmyk_convert (the YCbCr
    tables, K passed through);
  * arithmetic coding (SOF9 sequential, SOF10 progressive) as jdarith.c
    decodes it: the QM decoder of T.81 Annex D, DC and AC statistics per
    table with DAC's conditioning (defaults L=0, U=1, Kx=5), reset at
    every scan and restart, zero bits fed once the segment's data ends;
  * lossless (SOF3, Huffman) at 8 bits as jdlhuff.c, jdlossls.c and
    jddiffct.c decode it: predictors 1-7, the first row (and the first
    row after each restart) predicted from the left starting at
    1 << (P - Pt - 1), the first column from above, differences modulo
    2**16, samples shifted left by the point transform; libjpeg-turbo
    upsamples them by replication and converts no colour: three
    components are RGB unless a JFIF or an Adobe marker says YCbCr, which
    it refuses, as it refuses lossless YCCK.

PIL refuses 12-bit samples, hierarchical files (DHP, SOF5-7, SOF13-15),
arithmetic-coded lossless files (SOF11) and a height given only in a DNL
marker; this module raises NotImplementedError on them.

The entropy decoders are the serial part: Python loops over a bit
window with a 16-bit lookup per Huffman code, or over the QM decoder's
registers. Byte unstuffing and the split at restart markers are done up
front with numpy; dequantisation, IDCT, upsampling and colour conversion
work on whole arrays.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

_REFUSED = "PIL refuses it too; ROADMAP queue 1 item 18"

# jpeg_natural_order: zigzag index -> natural (row-major) index, with
# libjpeg's 16 extra entries of 63 for runs past the end of a block
_NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

# the frames PIL refuses (libjpeg-turbo reads no hierarchical frame and
# no arithmetic-coded lossless one)
_SOF_OTHER = {
    0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
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
    order coefficients each; lossless: one difference per sample)."""

    def __init__(self, payload, marker):
        if marker in _SOF_OTHER:
            raise NotImplementedError(
                f"{_SOF_OTHER[marker]} JPEG is not decoded ({_REFUSED})")
        precision, self.h, self.w, n = struct.unpack(">BHHB", payload[:6])
        if precision != 8:
            raise NotImplementedError(
                f"{precision}-bit JPEG is not decoded ({_REFUSED})")
        if self.h == 0:
            raise NotImplementedError(
                f"JPEG with its height in a DNL marker is not decoded "
                f"({_REFUSED})")
        self.progressive = marker in (0xC2, 0xCA)
        self.arithmetic = marker in (0xC9, 0xCA)
        self.lossless = marker == 0xC3
        self.unit = 1 if self.lossless else 8  # samples across a block
        self.comps = [_Component(payload[6 + 3 * i], payload[7 + 3 * i] >> 4,
                                 payload[7 + 3 * i] & 15, payload[8 + 3 * i])
                      for i in range(n)]
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.w // (self.unit * self.hmax))
        self.mcuy = -(-self.h // (self.unit * self.vmax))
        total = 0
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise ValueError("JPEG with fractional sampling factors")
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.dw = -(-self.w * c.h // self.hmax)
            c.dh = -(-self.h * c.v // self.vmax)
            c.offset = total
            total += c.bw * c.bh * self.unit ** 2
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


def _segments(buf: np.ndarray, start: int, end: int,
              windows: bool = True) -> list:
    """The entropy-coded data between start and end, split at its RST
    markers and unstuffed (0xFF 0x00 -> 0xFF), each segment as its list
    of 32-bit big-endian windows: window i holds bytes i..i+3, zeros past
    the end (libjpeg feeds zero bits past a marker); or, with windows
    False, as its bytes."""
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
        if not windows:
            out.append(data[a:b][keep[a:b]].tobytes())
            continue
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


def _lossless(win, blocks, coef, _ss, _se, _al, _n):
    """jdlhuff.c: one difference per sample, its category coded as a DC
    category (16: the difference 32768, no further bits)."""
    p = 0
    for base, _, dct, _ in blocks:
        e = dct[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        p += e & 31
        s = e >> 5
        v = 0
        if s == 16:
            v = 32768
        elif s:
            v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        coef[base] = v


# ---------------------------------------------------- arithmetic decoding

# T.81 Table D.2: (Qe, Next_Index_MPS, Next_Index_LPS with Switch_MPS in
# bit 7), and libjpeg's entry 113, the fixed probability 0.5 of the sign
# and refinement bits (jaricom.c)
_QE = [(qe, nmps, (switch << 7) | nlps) for qe, nmps, nlps, switch in (
    (0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0),
    (0x080b, 4, 18, 0), (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0),
    (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0), (0x0036, 9, 30, 0),
    (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 16, 36, 0), (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0),
    (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0), (0x0cef, 21, 43, 0),
    (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0),
    (0x01b1, 28, 54, 0), (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0),
    (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0), (0x0068, 33, 62, 0),
    (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0),
    (0x2ef1, 40, 67, 0), (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0),
    (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0), (0x1177, 45, 73, 0),
    (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0),
    (0x04de, 52, 50, 0), (0x040f, 53, 50, 0), (0x0363, 54, 51, 0),
    (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0), (0x01f8, 57, 54, 0),
    (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0),
    (0x008f, 32, 61, 0), (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0),
    (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0), (0x2fe8, 69, 83, 0),
    (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
    (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0),
    (0x119c, 76, 74, 0), (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0),
    (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0), (0x5832, 81, 80, 1),
    (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
    (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0),
    (0x2516, 71, 86, 0), (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0),
    (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0), (0x3824, 93, 99, 0),
    (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
    (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0),
    (0x3c3d, 100, 104, 0), (0x375e, 93, 99, 0), (0x5231, 102, 105, 0),
    (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0), (0x415e, 99, 103, 0),
    (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1),
    (0x5522, 109, 112, 0), (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0))]


def _qm_decoder(data):
    """jdarith.c's arith_decode over one restart segment's unstuffed
    bytes, zeros past their end: decode(stats, i) -> the bit, updating
    the bin stats[i] ((MPS << 7) | state)."""
    qe_table = _QE
    n = len(data)
    pos = a = c = 0
    ct = -16

    def decode(st, i):
        nonlocal pos, a, c, ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                byte = data[pos] if pos < n else 0
                pos += 1
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe, nm, nl = qe_table[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7

    return decode


class _Corrupt(Exception):
    """A magnitude or spectral overflow: jdarith.c warns and leaves the
    rest of the restart segment undecoded."""


def _arith_magnitude(decode, st, i, k_bins):
    """F.23-F.24 after the sign: the magnitude category from bin i (the
    X bins from k_bins, or for DC from 20 straight after the first), then
    its bits 14 bins on. Returns (|v|, the category bound m)."""
    m = decode(st, i)
    if m:
        if k_bins is None:
            i = 20
            while decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _Corrupt
                i += 1
        elif decode(st, i):
            m <<= 1
            i = k_bins
            while decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _Corrupt
                i += 1
    v = bound = m
    i += 14
    while m > 1:
        m >>= 1
        if decode(st, i):
            v |= m
    return v + 1, bound


def _arith_dc(decode, dc, s, lu):
    """One DC difference from context s (jdarith.c decode_mcu_DC_first):
    returns (difference, the next context)."""
    if not decode(dc, s):
        return 0, 0
    sign = decode(dc, s + 1)
    i = s + 2 + sign
    v, m = _arith_magnitude(decode, dc, i, None)
    low, up = lu
    if m < (1 << low) >> 1:
        ctx = 0
    elif m > (1 << up) >> 1:
        ctx = 12 + 4 * sign
    else:
        ctx = 4 + 4 * sign
    return (-v if sign else v), ctx


def _arith_ac(decode, ac, fixed, coef, base, ss, se, kx, al):
    """jdarith.c's AC loop (decode_mcu, decode_mcu_AC_first)."""
    nat = _NATURAL
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if decode(ac, i):
            break
        while not decode(ac, i + 1):
            i += 3
            k += 1
            if k > se:
                raise _Corrupt
        sign = decode(fixed, 0)
        v, _ = _arith_magnitude(decode, ac, i + 2,
                                189 if k <= kx else 217)
        coef[base + nat[k]] = (-v if sign else v) << al
        k += 1


def _arith_scan(segs, coef, ss, se, ah, al, n_slots, frame):
    """One arithmetic-coded scan, segs its (unstuffed bytes, blocks) per
    restart segment: each segment starts the decoder,
    the statistics and the DC predictions anew (jdarith.c
    process_restart)."""
    nat = _NATURAL
    p1, m1 = 1 << al, -1 << al
    lu, kx = frame.dac_lu, frame.dac_k
    for data, seg_blocks in segs:
        decode = _qm_decoder(data)
        dc_stats, ac_stats = {}, {}
        fixed = [113]
        last = [0] * n_slots
        ctx = [0] * n_slots
        try:
            for base, slot, td, ta in seg_blocks:
                if not frame.progressive or (ss == 0 and ah == 0):
                    dc = dc_stats.setdefault(td, bytearray(64))
                    diff, ctx[slot] = _arith_dc(decode, dc, ctx[slot],
                                                lu.get(td, (0, 1)))
                    last[slot] = (last[slot] + diff) & 0xFFFF
                    coef[base] = last[slot] << al
                    if not frame.progressive:
                        ac = ac_stats.setdefault(ta, bytearray(256))
                        _arith_ac(decode, ac, fixed, coef, base, 1, 63,
                                  kx.get(ta, 5), 0)
                elif ss == 0:
                    if decode(fixed, 0):
                        coef[base] |= p1
                elif ah == 0:
                    ac = ac_stats.setdefault(ta, bytearray(256))
                    _arith_ac(decode, ac, fixed, coef, base, ss, se,
                              kx.get(ta, 5), al)
                else:
                    ac = ac_stats.setdefault(ta, bytearray(256))
                    kex = se
                    while kex > 0 and not coef[base + nat[kex]]:
                        kex -= 1
                    k = ss
                    while k <= se:
                        i = 3 * (k - 1)
                        if k > kex and decode(ac, i):
                            break
                        while True:
                            j = base + nat[k]
                            cv = coef[j]
                            if cv:
                                if decode(ac, i + 2):
                                    coef[j] = cv + (m1 if cv < 0 else p1)
                                break
                            if decode(ac, i + 1):
                                coef[j] = m1 if decode(fixed, 0) else p1
                                break
                            i += 3
                            k += 1
                            if k > se:
                                raise _Corrupt
                        k += 1
        except _Corrupt:
            continue


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
    dac_lu: Dict[int, tuple] = {}   # DC table -> (L, U)
    dac_k: Dict[int, int] = {}      # AC table -> Kx
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
        elif marker == 0xCC:
            for i in range(0, len(payload) - 1, 2):
                tc, tb, cs = payload[i] >> 4, payload[i] & 15, payload[i + 1]
                if tc:
                    dac_k[tb] = cs
                else:
                    dac_lu[tb] = (cs & 15, cs >> 4)
        elif marker in (0xDE, 0xDF):
            raise NotImplementedError(
                f"hierarchical JPEG ({'DHP' if marker == 0xDE else 'EXP'} "
                f"marker) is not decoded ({_REFUSED})")
        elif marker == 0xE0 and payload[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and payload[:5] == b"Adobe":
            adobe = payload[11] if len(payload) > 11 else 0
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise ValueError("JPEG with two frames")
            frame = _Frame(payload, marker)
            frame.dac_lu, frame.dac_k = dac_lu, dac_k
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            end = _entropy_end(buf, pos)
            _scan(frame, payload, buf, pos, end, restart, qtables, dc_tabs,
                  ac_tabs)
            pos = end
    if frame is None:
        raise ValueError("JPEG without a frame header")
    return _output(frame, jfif, adobe)


def _scan(frame, payload, buf, pos, end, restart, qtables, dc_tabs,
          ac_tabs):
    """Decode one scan (its SOS payload and the entropy-coded data in
    buf[pos:end]) into the frame's coefficients (lossless: differences)."""
    comps = frame.comps
    n = payload[0]
    scomps = []
    for i in range(n):
        cid, tables = payload[1 + 2 * i], payload[2 + 2 * i]
        comp = next((c for c in comps if c.cid == cid), None)
        if comp is None or (not frame.lossless and comp.qt is None
                            and comp.tq not in qtables):
            raise ValueError(f"JPEG scan of component {cid}: no such "
                             "component or no quantisation table")
        if comp.qt is None:  # latched at the component's first scan
            comp.qt = qtables[comp.tq] if not frame.lossless else ()
        scomps.append((comp, tables >> 4, tables & 15))
    ss, se, ahal = payload[1 + 2 * n:4 + 2 * n]
    ah, al = ahal >> 4, ahal & 15
    if frame.lossless:
        decode = _lossless
    elif not frame.progressive:
        decode, ss, se, al = _sequential, 0, 63, 0
    elif ss == 0:
        decode = _dc_refine if ah else _dc_first
    else:
        decode = _ac_refine if ah else _ac_first

    # blocks (lossless: samples) in scan order: (MCUs, units per MCU)
    # coefficient bases
    u = frame.unit
    if n == 1:
        comp = scomps[0][0]
        by, bx = np.mgrid[0:-(-comp.dh // u), 0:-(-comp.dw // u)]
        bases = comp.offset + (by * comp.bw + bx).reshape(-1, 1) * u * u
        slots = [0]
        per_row = by.shape[1]
    else:
        my, mx = np.mgrid[0:frame.mcuy, 0:frame.mcux]
        my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
        cols, slots = [], []
        for slot, (comp, _, _) in enumerate(scomps):
            v, hh = np.mgrid[0:comp.v, 0:comp.h]
            blk = ((my * comp.v + v.reshape(1, -1)) * comp.bw
                   + mx * comp.h + hh.reshape(1, -1))
            cols.append(comp.offset + blk * u * u)
            slots += [slot] * (comp.v * comp.h)
        bases = np.concatenate(cols, 1)
        per_row = frame.mcux
    if frame.lossless:
        # jddiffct.c: restarts fall on MCU rows, each starts the
        # predictor's first row anew
        if restart % per_row:
            raise ValueError(f"lossless JPEG with a restart interval of "
                             f"{restart} MCUs, {per_row} to a row")
        for comp, _, _ in scomps:
            comp.psv, comp.pt = ss, al
            comp.rst_rows = (restart // per_row * (comp.v if n > 1 else 1)
                             if restart else None)
    per_mcu = len(slots)
    tables = []
    for _, td, ta in scomps:
        if frame.arithmetic:
            tables.append((td, ta))
            continue
        dc = (dc_tabs.get(td)
              if decode in (_sequential, _dc_first, _lossless) else [])
        ac = (ac_tabs.get(ta)
              if decode not in (_dc_first, _dc_refine, _lossless) else [])
        if dc is None or ac is None:
            raise ValueError("JPEG scan names an undefined Huffman table")
        tables.append((dc, ac))
    blocks = [(b, s) + tables[s] for b, s in zip(
        bases.ravel().tolist(), slots * len(bases))]

    mcus = len(blocks) // per_mcu
    step = restart if restart else mcus
    segs = _segments(buf, pos, end, windows=not frame.arithmetic)
    parts = [blocks[m0 * per_mcu:(m0 + step) * per_mcu]
             for m0 in range(0, mcus, step)]
    if frame.arithmetic:
        _arith_scan(list(zip(segs, parts)), frame.coef, ss, se, ah, al,
                    len(scomps), frame)
        return
    for win, part in zip(segs, parts):
        decode(win, part, frame.coef, ss, se, al, len(scomps))


def _undifference(diff: np.ndarray, psv: int, pt: int, rst_rows) -> np.ndarray:
    """jdlossls.c on a component's (rows, cols) differences: samples
    modulo 2**16. A first row (of the scan or after a restart) predicts
    from the left, its first sample from 1 << (8 - pt - 1); the other
    rows take the predictor psv, and their first sample the one above."""
    rows, cols = diff.shape
    x = np.zeros((rows, cols), np.int64)
    d = diff.astype(np.int64)
    for r in range(rows):
        if r == 0 or (rst_rows and r % rst_rows == 0):
            x[r] = (np.cumsum(d[r]) + (1 << (8 - pt - 1))) & 0xFFFF
            continue
        rb = x[r - 1]
        rc = np.concatenate([rb[:1], rb[:-1]])  # rc[0] is unused
        x0 = (d[r, 0] + rb[0]) & 0xFFFF
        if psv in (2, 3):
            x[r] = (d[r] + (rb if psv == 2 else rc)) & 0xFFFF
        elif psv in (1, 4, 5):
            # Ra's recurrence is linear: a running sum from the first
            # sample
            step = d[r, 1:] + {1: 0, 4: rb[1:] - rc[1:],
                               5: (rb[1:] - rc[1:]) >> 1}[psv]
            x[r] = (x0 + np.concatenate([[0], np.cumsum(step)])) & 0xFFFF
        else:
            row = [int(x0)]
            ra = int(x0)
            for di, rbi, rci in zip(d[r, 1:].tolist(), rb[1:].tolist(),
                                    rc[1:].tolist()):
                if psv == 6:
                    ra = (di + rbi + ((ra - rci) >> 1)) & 0xFFFF
                else:
                    ra = (di + ((ra + rbi) >> 1)) & 0xFFFF
                row.append(ra)
            x[r] = row
        x[r, 0] = x0
    return x


def _output(frame, jfif, adobe) -> np.ndarray:
    """IDCT (lossless: undifferencing), upsampling and colour conversion
    of the decoded frame."""
    h, w = frame.h, frame.w
    comps = frame.comps
    flat = np.array(frame.coef, np.int64).astype(np.int16)
    planes = []
    for c in comps:
        if c.qt is None:
            raise ValueError(f"JPEG component {c.cid} has no scan")
        fh, fv = frame.hmax // c.h, frame.vmax // c.v
        n = c.bw * c.bh
        if frame.lossless:
            x = _undifference(flat[c.offset:c.offset + n].reshape(
                c.bh, c.bw), c.psv, c.pt, c.rst_rows)
            plane = ((x << c.pt) & 0xFF).astype(np.uint8)[:c.dh, :c.dw]
            # jdsample.c replicates: no fancy upsampling of 1x1 "blocks"
            full = np.repeat(np.repeat(plane, fv, 0), fh, 1)
        else:
            blocks = idct_islow(
                flat[c.offset:c.offset + n * 64].reshape(n, 64), c.qt)
            plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
            plane = plane.reshape(c.bh * 8, c.bw * 8)
            full = upsample(plane, c.dw, c.dh, fh, fv)
        planes.append(full[:h, :w])
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if len(comps) == 1:
        out[..., :3] = planes[0][..., None]
    elif len(comps) == 3:
        ids = tuple(c.cid for c in comps)
        if frame.lossless:
            # jdapimin.c: without a JFIF or Adobe marker a lossless file
            # is RGB, whatever its component ids
            rgb = not jfif and (adobe is None or adobe == 0)
            if not rgb:
                raise NotImplementedError(
                    "lossless YCbCr JPEG is not decoded: libjpeg-turbo "
                    f"converts no colour in lossless mode ({_REFUSED})")
        else:
            rgb = (not jfif and ((adobe is not None and adobe == 0)
                                 or (adobe is None and ids == (82, 71, 66))))
        out[..., :3] = (np.stack(planes, -1) if rgb
                        else ycc_to_rgb(*planes))
    elif len(comps) == 4:
        if adobe is not None and adobe != 0:
            if frame.lossless:
                raise NotImplementedError(
                    f"lossless YCCK JPEG is not decoded ({_REFUSED})")
            # jdcolor.c's ycck_cmyk_convert gives C, M, Y = 255 - R, G, B
            # of the YCbCr planes and K as it is; PIL inverts all four
            cmyk_inverted = np.concatenate(
                [ycc_to_rgb(*planes[:3]), 255 - planes[3][..., None]], -1)
        else:
            cmyk_inverted = 255 - np.stack(planes, -1)
        out[..., :3] = cmyk_to_rgb(cmyk_inverted)
    else:
        raise ValueError(f"JPEG with {len(comps)} components")
    return out
