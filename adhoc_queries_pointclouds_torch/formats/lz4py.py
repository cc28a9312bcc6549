"""Pure-Python LZ4 fallback (block + frame) — used only when the native
C++ codec (native/aqpc_native.cpp) is unavailable. The frame *compressor*
emits store-only (uncompressed) blocks, which is still a valid LZ4 frame;
the decompressor handles both compressed and stored blocks.
"""

from __future__ import annotations

import struct

LZ4F_MAGIC = 0x184D2204


def xxh32(data: bytes, seed: int = 0) -> int:
    P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        while i <= n - 16:
            (a, b, c, d) = struct.unpack_from("<4I", data, i)
            v1 = (rotl((v1 + a * P2) & M, 13) * P1) & M
            v2 = (rotl((v2 + b * P2) & M, 13) * P1) & M
            v3 = (rotl((v3 + c * P2) & M, 13) * P1) & M
            v4 = (rotl((v4 + d * P2) & M, 13) * P1) & M
            i += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 4 <= n:
        (k,) = struct.unpack_from("<I", data, i)
        h = (rotl((h + k * P3) & M, 17) * P4) & M
        i += 4
    while i < n:
        h = (rotl((h + data[i] * P5) & M, 11) * P1) & M
        i += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


def block_decompress(src: bytes | memoryview, dst_size_hint: int = 0) -> bytes:
    src = bytes(src)
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("malformed LZ4 block (bad offset)")
        mlen = token & 15
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - offset
        if offset >= mlen:
            out += out[start : start + mlen]
        else:
            for k in range(mlen):
                out.append(out[start + k])
    return bytes(out)


def frame_decompress(src: bytes | memoryview) -> tuple[bytes, int]:
    """Decode one LZ4 frame; returns (payload, bytes_consumed)."""
    src = bytes(src)
    if len(src) < 7 or struct.unpack_from("<I", src, 0)[0] != LZ4F_MAGIC:
        raise ValueError("not an LZ4 frame")
    i = 4
    flg = src[i]
    i += 2  # FLG + BD
    if (flg >> 6) & 3 != 1:
        raise ValueError("unsupported LZ4 frame version")
    block_checksum = (flg >> 4) & 1
    content_size = (flg >> 3) & 1
    content_checksum = (flg >> 2) & 1
    dict_id = flg & 1
    if content_size:
        i += 8
    if dict_id:
        i += 4
    i += 1  # header checksum
    out = bytearray()
    while True:
        (bsize,) = struct.unpack_from("<I", src, i)
        i += 4
        if bsize == 0:
            break
        stored = bool(bsize >> 31)
        bsize &= 0x7FFFFFFF
        chunk = src[i : i + bsize]
        i += bsize
        out += chunk if stored else block_decompress(chunk)
        if block_checksum:
            i += 4
    if content_checksum:
        i += 4
    return bytes(out), i


def frame_compress_stored(data: bytes) -> bytes:
    """Produce a valid LZ4 frame with uncompressed (stored) blocks only."""
    BLOCK = 4 * 1024 * 1024
    out = bytearray()
    out += struct.pack("<I", LZ4F_MAGIC)
    flg = (1 << 6) | (1 << 5) | (1 << 3)
    bd = 7 << 4
    desc = struct.pack("<BB", flg, bd) + struct.pack("<Q", len(data))
    out += desc
    out.append((xxh32(desc) >> 8) & 0xFF)
    for pos in range(0, len(data), BLOCK):
        chunk = data[pos : pos + BLOCK]
        out += struct.pack("<I", len(chunk) | 0x80000000)
        out += chunk
    out += struct.pack("<I", 0)
    return bytes(out)
