"""PNG reading and writing in numpy over the standard library's ``zlib``.

The TUM loader's image decode without ``cv2``, ``libpng`` or ``libjpeg``:
8-bit gray, 8-bit RGB and 16-bit gray images, non-interlaced, with any of
the five row filters (PNG spec section 9).  Colour images follow ``cv2``'s
channel order: ``read_png`` returns [H, W, 3] BGR and ``write_png`` takes
it, so ``read_png(p)`` equals ``cv2.imread(p, cv2.IMREAD_UNCHANGED)``.

Speed: rows filtered with None, Sub or Up reconstruct with whole-row numpy
operations (``np.cumsum`` in ``uint8`` along a row for Sub, down a run of
rows for Up).  Average and Paeth depend on the reconstructed pixel to the
left, so an image with such a row is reconstructed along its
anti-diagonals: every pixel of a diagonal depends only on the two before
it, which makes H + W - 1 sequential numpy steps (``_unfilter_diagonal``).
``zlib`` releases the GIL while it inflates, so frames decoded in a thread
pool (``io/tum.py``) overlap the device work.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
NONE, SUB, UP, AVERAGE, PAETH = range(5)
# (colour type, bit depth) -> channels
_FORMATS = {(0, 8): 1, (0, 16): 1, (2, 8): 3}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _unfilter_rows(F, codes, bpp):
    """Reconstruct [H, stride] uint8 rows whose filters are None, Sub or
    Up, with whole-row operations."""
    H, stride = F.shape
    R = F.copy()
    sub = codes == SUB
    if sub.any():
        R[sub] = np.cumsum(F[sub].reshape(-1, stride // bpp, bpp), axis=1,
                           dtype=np.uint8).reshape(-1, stride)
    up = np.flatnonzero(codes == UP)
    # each maximal run of Up rows adds down the rows from the row above it
    # (None or Sub, reconstructed already; zeros above the first row)
    for run in np.split(up, np.flatnonzero(np.diff(up) != 1) + 1):
        if run.size:
            k = run[0]
            above = R[k - 1:k] if k else np.zeros((1, stride), np.uint8)
            R[run] = np.cumsum(np.concatenate([above, F[run]]), axis=0,
                               dtype=np.uint8)[1:]
    return R


def _unfilter_diagonal(F, codes, bpp):
    """Reconstruct [H, stride] uint8 rows with any filters along the
    anti-diagonals of the pixel grid.

    Pixel (r, x) depends on (r, x-1), (r-1, x) and (r-1, x-1), which lie on
    the two diagonals before its own.  The grid is stored skewed, S[r + 1,
    r + x + 2] = pixel (r, x) (one zero row above, two zero columns to the
    left), so a diagonal is one column of S and its three neighbours are
    the column before (left, up) and the one before that (up-left).
    """
    H, stride = F.shape
    W = stride // bpp
    Fs = np.zeros((H, H + W + 2, bpp), np.int16)
    S = np.zeros((H + 1, H + W + 2, bpp), np.int16)
    px = F.reshape(H, W, bpp)
    for r in range(H):
        Fs[r, r + 2:r + 2 + W] = px[r]
    code = codes.astype(np.int64)[:, None]
    zero = np.zeros((H, bpp), np.int16)
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H, d + 1)
        c = d + 2
        a = S[lo + 1:hi + 1, c - 1]          # left
        b = S[lo:hi, c - 1]                  # up
        u = S[lo:hi, c - 2]                  # up-left
        pa = np.abs(b - u)
        pb = np.abs(a - u)
        pc = np.abs(a + b - 2 * u)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, u))
        pred = np.choose(code[lo:hi], (zero[:hi - lo], a, b, (a + b) >> 1,
                                       paeth))
        S[lo + 1:hi + 1, c] = (Fs[lo:hi, c] + pred) & 0xFF
    out = np.empty((H, W, bpp), np.uint8)
    for r in range(H):
        out[r] = S[r + 1, r + 2:r + 2 + W]
    return out.reshape(H, stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (gray), uint8 [H, W, 3] (BGR) or uint16
    [H, W] (16-bit gray)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, colour, _, _, interlace = header
    ch = _FORMATS.get((colour, depth))
    if ch is None or interlace:
        raise ValueError(
            f"unsupported PNG: colour type {colour}, bit depth {depth}, "
            f"interlace {interlace} (8-bit gray / RGB and 16-bit gray, "
            "non-interlaced, are read)")
    bpp = ch * depth // 8
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError("PNG image data of the wrong size")
    raw = raw.reshape(H, stride + 1)
    codes, F = raw[:, 0], raw[:, 1:]
    if codes.max(initial=0) > PAETH:
        raise ValueError(f"unknown PNG row filter {codes.max()}")
    if (codes >= AVERAGE).any():
        R = _unfilter_diagonal(F, codes, bpp)
    else:
        R = _unfilter_rows(F, codes, bpp)
    if depth == 16:
        return R.view(">u2").astype(np.uint16).reshape(H, W)
    if ch == 3:
        return np.ascontiguousarray(R.reshape(H, W, 3)[..., ::-1])
    return R.reshape(H, W)


def read_png(path: str) -> np.ndarray:
    """Read a PNG file (see ``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _filter(P, filter_type, bpp):
    """Filter [H, stride] uint8 rows of the original bytes with one filter
    type (encoding reads only original bytes, so it is whole-array)."""
    P = P.astype(np.int16)
    left = np.zeros_like(P)
    left[:, bpp:] = P[:, :-bpp]
    up = np.zeros_like(P)
    up[1:] = P[:-1]
    ul = np.zeros_like(P)
    ul[1:, bpp:] = P[:-1, :-bpp]
    if filter_type == NONE:
        pred = 0
    elif filter_type == SUB:
        pred = left
    elif filter_type == UP:
        pred = up
    elif filter_type == AVERAGE:
        pred = (left + up) >> 1
    elif filter_type == PAETH:
        pa, pb, pc = (np.abs(up - ul), np.abs(left - ul),
                      np.abs(left + up - 2 * ul))
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    else:
        raise ValueError(f"unknown PNG row filter {filter_type}")
    return ((P - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = UP) -> bytes:
    """uint8 [H, W] / [H, W, 3] (BGR) or uint16 [H, W] -> PNG bytes, every
    row filtered with ``filter_type`` (0 None ... 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        colour, depth, rows = 0, 16, img.astype(">u2").view(np.uint8)
        bpp = 2
    elif img.dtype == np.uint8 and img.ndim == 2:
        colour, depth, rows, bpp = 0, 8, img, 1
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        colour, depth, rows, bpp = 2, 8, img[..., ::-1], 3
    else:
        raise ValueError(f"write_png takes uint8 gray, uint8 BGR or uint16 "
                         f"gray, not {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    F = _filter(np.ascontiguousarray(rows).reshape(H, W * bpp), filter_type,
                bpp)
    raw = np.concatenate([np.full((H, 1), filter_type, np.uint8), F], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = UP) -> None:
    """Write ``img`` as a PNG file (see ``encode_png``)."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
