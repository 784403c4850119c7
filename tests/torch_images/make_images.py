#!/usr/bin/env python3
"""Write the committed JPEG textures of chip_smoke.py's JPEG glTF phase.

    python3 tests/torch_images/make_images.py

The eight textures are the bench colonnade's own (chip_smoke.SCENE, as
chip_smoke.gltf_textures sizes them: 1024x1024 REPEAT, and 2048x512 CLAMP
for textures 3, 4 and 7), each encoded by PIL at quality 75 in one of the
forms below, so that across the set the port's JPEG decoder
(vkr_tpu_torch/scene/jpeg.py) meets baseline and progressive scans,
4:2:0, 4:2:2 and 4:4:4 sampling, optimised Huffman tables, restart
markers, greyscale and CMYK. digests.json keeps, per file, its form and
the SHA-256 of PIL's Image.open(...).convert("RGBA") bytes ((H, W, 4)
uint8, C order), which the phase holds the port's decode to.

It also writes four small JPEGs in the samplings PIL cannot write, 4:4:0
and 4:1:1, baseline and progressive, with OpenCV's encoder; the CPU tests
(tests/test_torch_images.py) hold the port's decode of them to PIL's.
Needs PIL and OpenCV; prints each file's size.

    python3 tests/torch_images/make_images.py --item18

writes only the JPEG forms that neither PIL nor OpenCV writes (ROADMAP
queue 1 item 18; ITEM18 below), with the small numpy encoder of this
file: YCCK, arithmetic coding (sequential and progressive, restarts,
DAC), lossless at 8 bits (predictors 1-7, point transforms, restarts,
grey, RGB, box-upsampled 4:2:0 and 4:2:2, CMYK), and the forms PIL
refuses (a lossless file that needs colour conversion, lossless YCCK,
arithmetic lossless, 12-bit samples, a hierarchical file, a height in a
DNL marker). digests.json records, per file, whether PIL decodes it and
the SHA-256 of its convert("RGBA") where it does, or its error. Needs
PIL only.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
QUALITY = 75
# texture index -> (PIL mode, save options, form)
FORMS = {
    0: ("RGB", dict(subsampling="4:2:0"), "baseline 4:2:0"),
    1: ("RGB", dict(subsampling="4:2:2", progressive=True),
        "progressive 4:2:2"),
    2: ("RGB", dict(subsampling="4:4:4", optimize=True,
                    restart_marker_rows=2),
        "baseline 4:4:4, optimised tables, a restart every 2 MCU rows"),
    3: ("RGB", dict(subsampling="4:2:0", progressive=True),
        "progressive 4:2:0"),
    4: ("RGB", dict(subsampling="4:2:0", restart_marker_blocks=64),
        "baseline 4:2:0, a restart every 64 MCUs"),
    5: ("CMYK", dict(), "CMYK (Adobe APP14), baseline"),
    6: ("L", dict(), "greyscale baseline"),
    7: ("L", dict(progressive=True), "greyscale progressive"),
}


# file -> (OpenCV sampling constant, progressive, height, width)
SAMPLINGS = {
    "sampling_440.jpg": ("IMWRITE_JPEG_SAMPLING_FACTOR_440", 0, 45, 61),
    "sampling_440_progressive.jpg": ("IMWRITE_JPEG_SAMPLING_FACTOR_440", 1,
                                     29, 37),
    "sampling_411.jpg": ("IMWRITE_JPEG_SAMPLING_FACTOR_411", 0, 45, 61),
    "sampling_411_progressive.jpg": ("IMWRITE_JPEG_SAMPLING_FACTOR_411", 1,
                                     29, 37),
}


# ------------------------------------------------------------ item 18
# A small numpy JPEG encoder for the forms PIL cannot write (ROADMAP
# queue 1 item 18): YCCK, arithmetic coding (SOF9, SOF10, SOF11),
# lossless (SOF3), 12-bit samples, a hierarchical file and a height in a
# DNL marker. It needs only to be valid: PIL's decode of its files is the
# reference the port is held to.

ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# T.81 Table D.2: (Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS), and
# libjpeg's entry 113, the fixed probability 0.5 of sign and refinement
# bits
QE_TABLE = [
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
    (0x5522, 109, 112, 0), (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0)]


def _segment(code: int, payload: bytes = b"") -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(payload) + 2) + payload


def _category(v: int) -> int:
    return abs(int(v)).bit_length()


class _Bits:
    """Huffman-coded entropy data: bits MSB first, 0xFF stuffed with 0x00,
    the last byte padded with ones."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _huffman(symbols):
    """A valid table for the symbols used: every one gets a code of the
    same length (all ones excluded). Returns (DHT counts and values,
    symbol -> (code, length))."""
    used = sorted(set(symbols))
    n = max(len(used), 1)
    length = n.bit_length()
    counts = [0] * 16
    counts[length - 1] = len(used)
    return (bytes(counts) + bytes(used),
            {s: (i, length) for i, s in enumerate(used)})


class _Arith:
    """The QM arithmetic encoder as libjpeg's jcarith.c runs it (T.81
    Annex D): statistics bins hold (MPS << 7) | state index."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _byte(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._byte(0)
            self.zc -= 1

    def encode(self, st, i, val):
        sv = st[i]
        qe, nmps, nlps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ ((switch << 7) | nlps)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) | nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._byte(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self._byte(0xFF)
                            self._byte(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        """jcarith.c's finish_pass (T.81 D.1.8); the coder starts anew."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._byte(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._byte(0xFF)
                    self._byte(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._byte(0)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._byte(0)
        self.zc = 0
        self.reset()


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


class Component:
    """One component of a frame: its id, sampling factors, quantisation
    and entropy table numbers and its samples at its own resolution."""

    def __init__(self, cid, h, v, plane, tq=0, td=0, ta=0):
        self.cid, self.h, self.v, self.tq, self.td, self.ta = (
            cid, h, v, tq, td, ta)
        self.plane = np.asarray(plane, np.int64)


class Frame:
    """A frame's geometry: the MCU grid and each component's block (or,
    lossless, sample) grid, padded by edge replication."""

    def __init__(self, comps, width, height, unit=8):
        self.comps, self.w, self.h, self.unit = comps, width, height, unit
        self.hmax = max(c.h for c in comps)
        self.vmax = max(c.v for c in comps)
        self.mcux = -(-width // (unit * self.hmax))
        self.mcuy = -(-height // (unit * self.vmax))
        for c in comps:
            c.dw = -(-width * c.h // self.hmax)
            c.dh = -(-height * c.v // self.vmax)
            assert c.plane.shape == (c.dh, c.dw), (c.plane.shape, c.dh, c.dw)
            c.padded = np.pad(c.plane, ((0, self.mcuy * c.v * unit - c.dh),
                                        (0, self.mcux * c.h * unit - c.dw)),
                              mode="edge")

    def units(self, scan):
        """Per MCU of a scan of the components scan (indices): the list of
        (component index, row, column) of its blocks or samples."""
        if len(scan) == 1:
            c = self.comps[scan[0]]
            ny = -(-c.dh // self.unit)
            nx = -(-c.dw // self.unit)
            return [[(scan[0], y, x)] for y in range(ny) for x in range(nx)]
        out = []
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                mcu = []
                for ci in scan:
                    c = self.comps[ci]
                    mcu += [(ci, my * c.v + yy, mx * c.h + xx)
                            for yy in range(c.v) for xx in range(c.h)]
                out.append(mcu)
        return out


def dct_coefficients(frame, qtables, precision=8):
    """Each component's quantised DCT coefficients, (rows, cols, 64) in
    zigzag order."""
    m = _dct_matrix()
    shift = 1 << (precision - 1)
    for c in frame.comps:
        p = c.padded.astype(np.float64) - shift
        ry, rx = p.shape[0] // 8, p.shape[1] // 8
        blocks = p.reshape(ry, 8, rx, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ux,abxy,vy->abuv", m, blocks, m).reshape(ry, rx, 64)
        q = np.asarray(qtables[c.tq], np.float64)
        c.coef = np.rint(f / q)[..., ZIGZAG].astype(np.int64)


def _dqt(qtables, sixteen=False):
    out = b""
    for t, q in qtables.items():
        zz = np.asarray(q)[ZIGZAG]
        out += (bytes([(1 << 4 if sixteen else 0) | t])
                + (zz.astype(">u2").tobytes() if sixteen
                   else zz.astype(np.uint8).tobytes()))
    return _segment(0xDB, out)


def _sof(code, frame, precision=8, height=None):
    payload = struct.pack(">BHHB", precision,
                          frame.h if height is None else height, frame.w,
                          len(frame.comps))
    for c in frame.comps:
        payload += bytes([c.cid, (c.h << 4) | c.v, c.tq])
    return _segment(code, payload)


def _sos(frame, scan, ss, se, ah, al):
    payload = bytes([len(scan)])
    for ci in scan:
        c = frame.comps[ci]
        payload += bytes([c.cid, (c.td << 4) | c.ta])
    return _segment(0xDA, payload + bytes([ss, se, (ah << 4) | al]))


def _restarts(units, restart):
    """units split into restart intervals."""
    step = restart or len(units)
    return [units[i:i + step] for i in range(0, len(units), step)]


def _join_intervals(parts):
    out = b""
    for i, part in enumerate(parts):
        if i:
            out += bytes([0xFF, 0xD0 + (i - 1) % 8])
        out += part
    return out


def huffman_sequential_scan(frame, scan, restart=0):
    """DHT and SOS segments and entropy data of a sequential Huffman scan
    of the DCT coefficients."""
    events = []  # per interval: (table kind, table, symbol, bits, length)
    for interval in _restarts(frame.units(scan), restart):
        ev = []
        pred = {}
        for mcu in interval:
            for ci, y, x in mcu:
                c = frame.comps[ci]
                blk = c.coef[y, x]
                diff = int(blk[0]) - pred.get(ci, 0)
                pred[ci] = int(blk[0])
                s = _category(diff)
                ev.append((0, c.td, s, diff if diff >= 0 else
                           diff + (1 << s) - 1, s))
                run = 0
                last = max([k for k in range(1, 64) if blk[k]], default=0)
                for k in range(1, last + 1):
                    v = int(blk[k])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        ev.append((1, c.ta, 0xF0, 0, 0))
                        run -= 16
                    s = _category(v)
                    ev.append((1, c.ta, (run << 4) | s,
                               v if v >= 0 else v + (1 << s) - 1, s))
                    run = 0
                if last < 63:
                    ev.append((1, c.ta, 0x00, 0, 0))
        events.append(ev)
    return _huffman_scan(frame, scan, 0, 63, 0, 0, events)


def _huffman_scan(frame, scan, ss, se, ah, al, events):
    tables = {}
    for ev in events:
        for kind, t, sym, _, _ in ev:
            tables.setdefault((kind, t), []).append(sym)
    dht, codes = b"", {}
    for key in sorted(tables):
        spec, codes[key] = _huffman(tables[key])
        dht += bytes([(key[0] << 4) | key[1]]) + spec
    parts = []
    for ev in events:
        bits = _Bits()
        for kind, t, sym, extra, n in ev:
            bits.put(*codes[(kind, t)][sym])
            if n:
                bits.put(extra, n)
        parts.append(bits.flush())
    return (_segment(0xC4, dht) + _sos(frame, scan, ss, se, ah, al)
            + _join_intervals(parts))


# ---- arithmetic-coded DCT scans (jcarith.c)

class _ArithStats:
    """One restart interval's statistics bins (64 DC, 256 AC per table),
    DC predictions and contexts per component, and the fixed bin."""

    def __init__(self, tables, scan_comps):
        self.dc = {t: bytearray(64) for t in tables}
        self.ac = {t: bytearray(256) for t in tables}
        self.last = {ci: 0 for ci in scan_comps}
        self.ctx = {ci: 0 for ci in scan_comps}
        self.fixed = bytearray([113])


def _arith_value(enc, st, base, k_split, v, dc_ctx=None):
    """T.81 F.1.4.4 (F.6-F.9) for v != 0 after the sign: the magnitude
    category and bits of |v| - 1; st[base] is SP/SN (DC) or S0 + 2
    (AC). Returns the category bound m."""
    v = abs(v) - 1
    m = 0
    i = base
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v
        if dc_ctx is not None:
            i = 20
            while True:
                v2 >>= 1
                if not v2:
                    break
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
        else:
            v2 >>= 1
            if v2:
                enc.encode(st, i, 1)
                m <<= 1
                i = k_split
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
    enc.encode(st, i, 0)
    bound = m
    i += 14
    while m > 1:
        m >>= 1
        enc.encode(st, i, 1 if (m & v) else 0)
    return bound


def _arith_dc(enc, stats, tbl, ci, diff, lu):
    st = stats.dc[tbl]
    s0 = stats.ctx[ci]
    if diff == 0:
        enc.encode(st, s0, 0)
        stats.ctx[ci] = 0
        return
    enc.encode(st, s0, 1)
    sign = diff < 0
    enc.encode(st, s0 + 1, int(sign))
    m = _arith_value(enc, st, s0 + 2 + sign, None, diff, dc_ctx=True)
    low, up = lu
    if m < (1 << low) >> 1:
        stats.ctx[ci] = 0
    elif m > (1 << up) >> 1:
        stats.ctx[ci] = 12 + 4 * sign
    else:
        stats.ctx[ci] = 4 + 4 * sign


def _arith_ac(enc, stats, tbl, values, ss, se, kx):
    """values[k] (zigzag, already point-transformed) for k in ss..se."""
    st = stats.ac[tbl]
    ke = max([k for k in range(ss, se + 1) if values[k]], default=ss - 1)
    k = ss
    while k <= ke:
        enc.encode(st, 3 * (k - 1), 0)
        while values[k] == 0:
            enc.encode(st, 3 * (k - 1) + 1, 0)
            k += 1
        enc.encode(st, 3 * (k - 1) + 1, 1)
        v = values[k]
        enc.encode(stats.fixed, 0, int(v < 0))
        _arith_value(enc, st, 3 * (k - 1) + 2, 189 if k <= kx else 217, v)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _arith_ac_refine(enc, stats, tbl, blk, ss, se, ah, al):
    st = stats.ac[tbl]

    def at(k, shift):
        v = int(blk[k])
        return (v if v >= 0 else -v) >> shift

    ke = max([k for k in range(1, se + 1) if at(k, al)], default=0)
    kex = max([k for k in range(1, ke + 1) if at(k, ah)], default=0)
    k = ss
    while k <= ke:
        if k > kex:
            enc.encode(st, 3 * (k - 1), 0)
        while True:
            v = at(k, al)
            if v:
                if v >> 1:
                    enc.encode(st, 3 * (k - 1) + 2, v & 1)
                else:
                    enc.encode(st, 3 * (k - 1) + 1, 1)
                    enc.encode(stats.fixed, 0, int(blk[k] < 0))
                break
            enc.encode(st, 3 * (k - 1) + 1, 0)
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def arith_scan(frame, scan, ss=0, se=63, ah=0, al=0, progressive=False,
               restart=0, dac=None):
    """SOS segment and entropy data of an arithmetic-coded DCT scan:
    sequential, or one progressive scan (DC first or refinement, AC
    first or refinement). dac: table -> ((L, U), K)."""
    dac = dac or {}
    tables = {frame.comps[ci].td for ci in scan} | {
        frame.comps[ci].ta for ci in scan}
    parts = []
    for interval in _restarts(frame.units(scan), restart):
        enc = _Arith()
        stats = _ArithStats(tables, scan)
        for mcu in interval:
            for ci, y, x in mcu:
                c = frame.comps[ci]
                blk = c.coef[y, x]
                lu, kx = dac.get(c.td, ((0, 1), 5))[0], dac.get(
                    c.ta, ((0, 1), 5))[1]
                if not progressive:
                    diff = int(blk[0]) - stats.last[ci]
                    stats.last[ci] = int(blk[0])
                    _arith_dc(enc, stats, c.td, ci, diff, lu)
                    _arith_ac(enc, stats, c.ta, [int(v) for v in blk], 1,
                              63, kx)
                elif ss == 0 and ah == 0:
                    m = int(blk[0]) >> al
                    diff = m - stats.last[ci]
                    stats.last[ci] = m
                    _arith_dc(enc, stats, c.td, ci, diff, lu)
                elif ss == 0:
                    enc.encode(stats.fixed, 0, (int(blk[0]) >> al) & 1)
                elif ah == 0:
                    vals = [0] * 64
                    for k in range(ss, se + 1):
                        v = int(blk[k])
                        vals[k] = (v >> al if v >= 0 else -((-v) >> al))
                    _arith_ac(enc, stats, c.ta, vals, ss, se, kx)
                else:
                    _arith_ac_refine(enc, stats, c.ta, blk, ss, se, ah, al)
        enc.finish()
        parts.append(bytes(enc.out))
    return _sos(frame, scan, ss, se, ah, al) + _join_intervals(parts)


def dac_segment(dac):
    """DAC: table -> ((L, U), K), for the DC and AC tables."""
    payload = b""
    for t, ((low, up), k) in sorted(dac.items()):
        payload += bytes([t, (up << 4) | low, 0x10 | t, k])
    return _segment(0xCC, payload)


# ---- lossless (jclossls.c): predictor differences of the samples

def lossless_differences(frame, psv, pt, restart=0, precision=8):
    """Each component's differences (padded rows, cols) under predictor
    psv (1-7) and point transform pt: the first row of the scan and of
    every restart interval predicts from the left (its first sample from
    1 << (P - Pt - 1)), the first column of the other rows from above."""
    rows_per_restart = (restart // frame.mcux) if restart else 0
    for c in frame.comps:
        x = c.padded >> pt
        pred = np.zeros_like(x)
        for r in range(x.shape[0]):
            first = r == 0 or (rows_per_restart
                               and r % (rows_per_restart * c.v) == 0)
            ra = np.concatenate([[0], x[r, :-1]])
            if first:
                pred[r] = ra
                pred[r, 0] = 1 << (precision - pt - 1)
                continue
            rb = x[r - 1]
            rc = np.concatenate([[0], x[r - 1, :-1]])
            pred[r] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                       5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                       7: (ra + rb) >> 1}[psv]
            pred[r, 0] = rb[0]
        c.diff = x - pred


def lossless_huffman_scan(frame, scan, psv, pt, restart=0):
    events = []
    for interval in _restarts(frame.units(scan), restart):
        ev = []
        for mcu in interval:
            for ci, y, x in mcu:
                c = frame.comps[ci]
                d = int(c.diff[y, x])
                s = _category(d)
                ev.append((0, c.td, s, d if d >= 0 else d + (1 << s) - 1,
                           s if s < 16 else 0))
        events.append(ev)
    return _huffman_scan(frame, scan, psv, 0, 0, pt, events)


# ---- arithmetic-coded lossless (SOF11), T.81 H.1.2.3: the DC model of
# F.1.4.4.1 with a two-dimensional context, the classes of the
# differences of the left (Da) and upper (Db) samples

def _lossless_class(d, lu):
    low, up = lu
    if abs(d) <= ((1 << low) >> 1):
        return 0
    if abs(d) <= (1 << up) >> 1:
        return 1 if d > 0 else 2
    return 3 if d > 0 else 4


def lossless_arith_scan(frame, scan, psv, pt, lu=(0, 1)):
    """SOS and entropy data of an SOF11 scan (one restart interval):
    context 5 * class(Da) + class(Db) picks S0 = 4 * context (SS, SP, SN
    follow it); the magnitude bins X1.. start at 100, or at 129 when Db is
    large, and their bits 14 bins on."""
    enc = _Arith()
    st = bytearray(160)
    units = frame.units(scan)
    for mcu in units:
        for ci, y, x in mcu:
            c = frame.comps[ci]
            d = int(c.diff[y, x])
            da = int(c.diff[y, x - 1]) if x else 0
            db = int(c.diff[y - 1, x]) if y else 0
            ca, cb = _lossless_class(da, lu), _lossless_class(db, lu)
            s0 = 4 * (5 * ca + cb)
            if d == 0:
                enc.encode(st, s0, 0)
                continue
            enc.encode(st, s0, 1)
            sign = d < 0
            enc.encode(st, s0 + 1, int(sign))
            v = abs(d) - 1
            i, m = s0 + 2 + sign, 0
            if v:
                enc.encode(st, i, 1)
                m, v2 = 1, v
                i = 129 if cb > 2 else 100
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
            enc.encode(st, i, 0)
            i += 14
            while m > 1:
                m >>= 1
                enc.encode(st, i, 1 if (m & v) else 0)
    enc.finish()
    return _sos(frame, scan, psv, 0, 0, pt) + bytes(enc.out)


def file_name(t: int) -> str:
    return f"colonnade_tex{t}.jpg"


def rgba_digest(data: bytes) -> str:
    """SHA-256 of PIL's convert("RGBA") of the image bytes."""
    import numpy as np
    from PIL import Image

    rgba = np.ascontiguousarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    return hashlib.sha256(rgba.tobytes()).hexdigest()


def main() -> int:
    import PIL
    from PIL import Image, features

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import chip_smoke
    from vkr_tpu_torch.scene.procedural import build_colonnade

    src = build_colonnade(**chip_smoke.SCENE)
    images, _ = chip_smoke.gltf_textures(src.images)
    digests = {}
    total = 0
    for t, (mode, options, form) in FORMS.items():
        out = io.BytesIO()
        Image.fromarray(images[t][..., :3]).convert(mode).save(
            out, "JPEG", quality=QUALITY, **options)
        data = out.getvalue()
        with open(os.path.join(HERE, file_name(t)), "wb") as f:
            f.write(data)
        h, w = images[t].shape[:2]
        digests[file_name(t)] = dict(texture=t, form=form, shape=[h, w, 4],
                                     rgba_sha256=rgba_digest(data))
        total += len(data)
        print(f"{file_name(t)}: {w}x{h}, {form}, {len(data)} bytes")
    digests["made_with"] = (f"Pillow {PIL.__version__}, libjpeg-turbo "
                            f"{features.version('libjpeg_turbo')}")
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")
    print(f"total {total} bytes ({digests['made_with']})")
    write_samplings()
    write_item18()
    return 0


def write_samplings() -> None:
    """SAMPLINGS at quality 90, from a seeded image of gradients and
    noise (OpenCV takes BGR; the files hold its YCbCr)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:45, 0:61]
    img = np.stack([128 + 100 * np.sin(x / 5), 128 + 80 * np.cos(y / 7),
                    128 + 60 * np.sin((x + y) / 9)], -1)
    img = np.clip(img + rng.normal(0, 20, img.shape), 0,
                  255).astype(np.uint8)
    for name, (sampling, progressive, h, w) in SAMPLINGS.items():
        ok, data = cv2.imencode(".jpg", img[:h, :w], [
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, sampling), cv2.IMWRITE_JPEG_PROGRESSIVE,
            progressive])
        if not ok:
            raise RuntimeError(f"OpenCV could not encode {name}")
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data.tobytes())
        print(f"{name}: {w}x{h}, OpenCV {cv2.__version__}, "
              f"{len(data)} bytes")


# ---- the item-18 samples

ITEM18_SIZE = (45, 61)   # (height, width): odd, partial MCUs at both edges
QTABLES = {0: (4 + np.add.outer(np.arange(8), np.arange(8))).reshape(-1),
           1: (8 + 2 * np.add.outer(np.arange(8), np.arange(8))).reshape(-1)}
_JFIF = _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _adobe(transform):
    return _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                 transform))


def _dri(interval):
    return _segment(0xDD, struct.pack(">H", interval))


def _planes(h, w, seed, n):
    """n seeded planes of waves and noise, (h, w, n) int64 in 0..255."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + seed + i)
                     * np.cos(y / (7 + i)) for i in range(n)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, n)), 0,
                   255).astype(np.int64)


def _frame(samp, seed, ids=None, unit=8, size=ITEM18_SIZE, scale=1):
    """A frame of len(samp) components with sampling factors samp, each
    plane box-averaged down to its own resolution; tables 0 for the
    first component, 1 for the others."""
    h, w = size
    img = _planes(h, w, seed, len(samp)) * scale
    hm = max(a for a, _ in samp)
    vm = max(b for _, b in samp)
    comps = []
    for i, (hh, vv) in enumerate(samp):
        fy, fx = vm // vv, hm // hh
        ph, pw = -(-h // fy) * fy, -(-w // fx) * fx
        p = np.pad(img[..., i], ((0, ph - h), (0, pw - w)), mode="edge")
        plane = np.rint(p.reshape(ph // fy, fy, pw // fx, fx).mean((1, 3)))
        t = min(i, 1)
        comps.append(Component(ids[i] if ids else i + 1, hh, vv,
                               plane.astype(np.int64), tq=t, td=t, ta=t))
    return Frame(comps, w, h, unit)


def _jpeg(*parts):
    return b"\xff\xd8" + b"".join(parts) + b"\xff\xd9"


def _progressive(f, restart=0, dac=None):
    """A spectral-selection and successive-approximation script: DC first
    (Al 1) interleaved, AC bands first and refined per component, DC
    refined."""
    n = len(f.comps)
    every = list(range(n))
    out = arith_scan(f, every, 0, 0, 0, 1, True, restart, dac)
    for ci in reversed(every):
        if ci == 0:
            out += arith_scan(f, [0], 1, 5, 0, 2, True, restart, dac)
            out += arith_scan(f, [0], 6, 63, 0, 2, True, restart, dac)
            out += arith_scan(f, [0], 1, 63, 2, 1, True, restart, dac)
        else:
            out += arith_scan(f, [ci], 1, 63, 0, 1, True, restart, dac)
    out += arith_scan(f, every, 0, 0, 1, 0, True, restart, dac)
    for ci in reversed(every):
        out += arith_scan(f, [ci], 1, 63, 1, 0, True, restart, dac)
    return out


def _ycck():
    f = _frame(((2, 2), (1, 1), (1, 1), (2, 2)), 11)
    f.comps[3].tq = f.comps[3].td = f.comps[3].ta = 0
    dct_coefficients(f, QTABLES)
    return _jpeg(_adobe(2), _dqt(QTABLES), _sof(0xC0, f),
                 huffman_sequential_scan(f, [0, 1, 2, 3]))


def _sof9(samp, seed, restart=0, dac=None, markers=_JFIF):
    f = _frame(samp, seed)
    dct_coefficients(f, QTABLES)
    return _jpeg(markers, _dqt(QTABLES),
                 dac_segment(dac) if dac else b"",
                 _dri(restart) if restart else b"", _sof(0xC9, f),
                 arith_scan(f, list(range(len(samp))), restart=restart,
                            dac=dac))


def _sof10(samp, seed, restart=0, dac=None, size=ITEM18_SIZE):
    f = _frame(samp, seed, size=size)
    dct_coefficients(f, QTABLES)
    return _jpeg(_JFIF, _dqt(QTABLES), dac_segment(dac) if dac else b"",
                 _dri(restart) if restart else b"", _sof(0xCA, f),
                 _progressive(f, restart, dac))


def _sof3(samp, seed, psv, pt=0, restart=0, markers=b"", size=ITEM18_SIZE):
    f = _frame(samp, seed, unit=1, size=size)
    lossless_differences(f, psv, pt, restart)
    return _jpeg(markers, _dri(restart) if restart else b"", _sof(0xC3, f),
                 lossless_huffman_scan(f, list(range(len(samp))), psv, pt,
                                       restart))


def _sof11():
    f = _frame(((1, 1),), 12, unit=1)
    lossless_differences(f, 1, 0)
    return _jpeg(_sof(0xCB, f), lossless_arith_scan(f, [0], 1, 0))


def _twelve_bit():
    f = _frame(((1, 1),), 13, scale=16)
    q = {0: QTABLES[0] * 8}
    dct_coefficients(f, q, precision=12)
    return _jpeg(_dqt(q, sixteen=True), _sof(0xC1, f, precision=12),
                 huffman_sequential_scan(f, [0]))


def _hierarchical():
    """DHP, a non-differential frame at half size, EXP doubling both
    ways, and a differential frame (SOF5) of zero differences."""
    h, w = ITEM18_SIZE
    full = _frame(((1, 1),), 14)
    half = _frame(((1, 1),), 14, size=(-(-h // 2), -(-w // 2)))
    dct_coefficients(half, QTABLES)
    c = full.comps[0]
    c.coef = np.zeros((c.padded.shape[0] // 8, c.padded.shape[1] // 8, 64),
                      np.int64)
    dhp = _sof(0xDE, full)
    return _jpeg(dhp, _dqt(QTABLES), _sof(0xC1, half),
                 huffman_sequential_scan(half, [0]),
                 _segment(0xDF, bytes([0x11])), _sof(0xC5, full),
                 huffman_sequential_scan(full, [0]))


def _dnl():
    f = _frame(((2, 2), (1, 1), (1, 1)), 15)
    dct_coefficients(f, QTABLES)
    return _jpeg(_JFIF, _dqt(QTABLES), _sof(0xC0, f, height=0),
                 huffman_sequential_scan(f, [0, 1, 2]),
                 _segment(0xDC, struct.pack(">H", f.h)))


# file -> (form, bytes); ROADMAP queue 1 item 18's forms in its order
ITEM18 = {
    "item18_ycck.jpg": ("YCCK (Adobe transform 2), baseline, Y and K 2x2",
                        _ycck),
    "item18_sof9_420.jpg": ("arithmetic sequential (SOF9) 4:2:0",
                            lambda: _sof9(((2, 2), (1, 1), (1, 1)), 21)),
    "item18_sof9_422_restart_dac.jpg": (
        "arithmetic sequential (SOF9) 4:2:2, a restart every 7 MCUs, DAC "
        "L=2 U=5 K=1 and L=1 U=1 K=40",
        lambda: _sof9(((2, 1), (1, 1), (1, 1)), 22, 7,
                      {0: ((2, 5), 1), 1: ((1, 1), 40)})),
    "item18_sof9_grey.jpg": ("arithmetic sequential (SOF9) greyscale",
                             lambda: _sof9(((1, 1),), 23, markers=b"")),
    "item18_sof10_420.jpg": ("arithmetic progressive (SOF10) 4:2:0",
                             lambda: _sof10(((2, 2), (1, 1), (1, 1)), 24)),
    "item18_sof10_444_restart_dac.jpg": (
        "arithmetic progressive (SOF10) 4:4:4, a restart every 5 MCUs, "
        "DAC L=1 U=3 K=2 and L=0 U=0 K=12",
        lambda: _sof10(((1, 1), (1, 1), (1, 1)), 25, 5,
                       {0: ((1, 3), 2), 1: ((0, 0), 12)})),
    **{f"item18_sof3_p{p}.jpg": (
        f"lossless (SOF3) greyscale, predictor {p}, point transform "
        f"{p % 3}" + (", a restart every 3 rows" if p == 4 else ""),
        lambda p=p: _sof3(((1, 1),), 30 + p, p, p % 3,
                          3 * ITEM18_SIZE[1] if p == 4 else 0))
       for p in range(1, 8)},
    "item18_sof3_rgb.jpg": (
        "lossless (SOF3) RGB, no JFIF or Adobe marker, predictor 6",
        lambda: _sof3(((1, 1),) * 3, 40, 6)),
    "item18_sof3_420.jpg": (
        "lossless (SOF3) 4:2:0, Adobe transform 0, predictor 5, restarts",
        lambda: _sof3(((2, 2), (1, 1), (1, 1)), 41, 5, 0, 31 * 2,
                      _adobe(0))),
    "item18_sof3_cmyk.jpg": ("lossless (SOF3) CMYK, predictor 4",
                             lambda: _sof3(((1, 1),) * 4, 42, 4)),
    "item18_sof10_256.jpg": (
        "arithmetic progressive (SOF10) 4:2:0, 256x256",
        lambda: _sof10(((2, 2), (1, 1), (1, 1)), 50, size=(256, 256))),
    "item18_sof3_256.jpg": (
        "lossless (SOF3) RGB, predictor 7, 256x256",
        lambda: _sof3(((1, 1),) * 3, 51, 7, size=(256, 256))),
    # the forms PIL refuses
    "item18_sof3_jfif.jpg": (
        "lossless (SOF3) with a JFIF marker: YCbCr, which libjpeg-turbo "
        "does not convert in lossless mode",
        lambda: _sof3(((1, 1),) * 3, 43, 1, markers=_JFIF)),
    "item18_sof3_ycck.jpg": (
        "lossless (SOF3) YCCK (Adobe transform 2)",
        lambda: _sof3(((1, 1),) * 4, 44, 1, markers=_adobe(2))),
    "item18_sof11.jpg": ("arithmetic lossless (SOF11) greyscale, "
                         "predictor 1", _sof11),
    "item18_12bit.jpg": ("12-bit extended sequential (SOF1) greyscale, "
                         "16-bit DQT", _twelve_bit),
    "item18_hierarchical.jpg": (
        "hierarchical: DHP, a half-size SOF1 frame, EXP, a differential "
        "SOF5 frame", _hierarchical),
    "item18_dnl.jpg": ("baseline 4:2:0 with its height only in a DNL "
                       "marker", _dnl),
}


def write_item18() -> None:
    """Write ITEM18 and record PIL's reading of each in digests.json."""
    import PIL
    from PIL import Image, features

    path = os.path.join(HERE, "digests.json")
    with open(path) as f:
        digests = json.load(f)
    digests = {k: v for k, v in digests.items() if not k.startswith(
        "item18_")}
    for name, (form, make) in ITEM18.items():
        data = make()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        entry = dict(form=form)
        try:
            rgba = np.ascontiguousarray(
                Image.open(io.BytesIO(data)).convert("RGBA"))
            entry.update(pil="decodes", shape=list(rgba.shape),
                         rgba_sha256=hashlib.sha256(
                             rgba.tobytes()).hexdigest())
        except (OSError, SyntaxError, ValueError) as e:
            entry.update(pil="refuses", error=type(e).__name__ + ": "
                         + str(e).split(" <")[0])
        digests[name] = entry
        print(f"{name}: {form}, {len(data)} bytes, PIL {entry['pil']}")
    digests["made_with"] = (f"Pillow {PIL.__version__}, libjpeg-turbo "
                            f"{features.version('libjpeg_turbo')}")
    with open(path, "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--item18"]:
        write_item18()
        sys.exit(0)
    sys.exit(main())
