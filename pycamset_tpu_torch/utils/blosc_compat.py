"""Pure-Python codec for c-blosc1 frames (`.camset` interop).

Copy of ``pycamset_tpu/utils/blosc_compat.py`` (ctypes, struct and zlib
only), kept in the port so that it imports nothing of the JAX package.

The upstream pyCamSet persists detection tables with
``blosc.compress_ptr(..., cname='lz4', shuffle=1)`` (pyCamSet
``utils/saving.py:240-332``). python-blosc is not a dependency, so this
module re-implements just enough of the c-blosc1 container to READ those
frames:

- the 16-byte blosc1 header (flags carry codec id / shuffle / memcpy bits),
- per-block int32 start offsets,
- optional block splitting into `typesize` streams (c-blosc "forward
  compatible" split policy — handled by trying split first, then unsplit),
- LZ4 block-format decompression (pure Python),
- zlib-coded frames (stdlib inflate),
- byte-shuffle reversal via numpy reshape/transpose.

WRITE support: :func:`blosc_compress_frame` emits frames that python-blosc
can decompress — through the system libblosc (lz4 + shuffle, byte-identical
to pyCamSet's own writes) when it is present, else a pure-Python zlib-codec
frame (codec id 3, unsplit streams — c-blosc's own split policy for zlib —
with the byte-shuffle filter), falling back to a memcpy frame when
compression does not pay. `.camset` files written by the port
(``utils/saving.py``, the same chunked dict layout around these frames)
therefore load in pyCamSet and in the JAX package.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import struct
import zlib

import numpy as np


def _load_native():
    """Bind the system libblosc via ctypes when present (python-blosc is
    not installed, but the shared library ships with the image)."""
    name = ctypes.util.find_library("blosc")
    if name is None:
        return None
    try:
        lib = ctypes.CDLL(name)
        lib.blosc_init()
        lib.blosc_decompress.restype = ctypes.c_int
        lib.blosc_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.blosc_compress.restype = ctypes.c_int
        lib.blosc_compress.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.blosc_set_compressor.restype = ctypes.c_int
        lib.blosc_set_compressor.argtypes = [ctypes.c_char_p]
        return lib
    except OSError:
        return None


_NATIVE = _load_native()


def native_blosc_available() -> bool:
    return _NATIVE is not None


def blosc_decompress_native(frame: bytes) -> bytes:
    """Decompress through the system libblosc (raises if unavailable)."""
    if _NATIVE is None:
        raise BloscDecodeError("system libblosc is not available")
    if len(frame) < HEADER_LEN:
        raise BloscDecodeError("frame shorter than a blosc header")
    (nbytes,) = struct.unpack_from("<i", frame, 4)
    (cbytes,) = struct.unpack_from("<i", frame, 12)
    # validate before handing the buffer to C: a corrupt header could make
    # libblosc read past the end of the input frame
    if nbytes < 0:
        raise BloscDecodeError(f"negative uncompressed size {nbytes}")
    if cbytes != len(frame):
        raise BloscDecodeError(
            f"header says {cbytes} bytes, frame has {len(frame)}")
    out = ctypes.create_string_buffer(max(nbytes, 1))
    rc = _NATIVE.blosc_decompress(frame, out, nbytes)
    if rc != nbytes:
        raise BloscDecodeError(f"libblosc returned {rc}, wanted {nbytes}")
    return out.raw[:nbytes]


def blosc_compress_native(data: bytes, typesize: int, clevel: int = 3,
                          cname: bytes = b"lz4", shuffle: int = 1) -> bytes:
    """Compress through the system libblosc (test oracle / migration aid)."""
    if _NATIVE is None:
        raise BloscDecodeError("system libblosc is not available")
    _NATIVE.blosc_set_compressor(cname)
    out = ctypes.create_string_buffer(len(data) + HEADER_LEN)
    rc = _NATIVE.blosc_compress(clevel, shuffle, typesize, len(data),
                                data, out, len(out))
    if rc <= 0:
        raise BloscDecodeError(f"libblosc compress failed ({rc})")
    return out.raw[:rc]

# header flag bits (c-blosc blosc.h)
_FLAG_BYTE_SHUFFLE = 0x1
_FLAG_MEMCPYED = 0x2
_FLAG_BIT_SHUFFLE = 0x4
_CODEC_SHIFT = 5  # codec id lives in flag bits 5-7

_CODEC_BLOSCLZ = 0
_CODEC_LZ4 = 1
_CODEC_SNAPPY = 2
_CODEC_ZLIB = 3
_CODEC_ZSTD = 4

# c-blosc split policy constants
_MAX_SPLITS = 16
_MIN_BUFFERSIZE = 128

HEADER_LEN = 16


class BloscDecodeError(ValueError):
    """The byte string is not a decodable blosc1 frame."""


def lz4_block_decompress(src: bytes, dst_size: int) -> bytes:
    """Decode one raw LZ4 block (no frame header) of known output size."""
    try:
        return _lz4_block_decompress(src, dst_size)
    except IndexError:
        # a read past the payload end means a truncated/garbled stream (or
        # the wrong split-mode guess); keep the documented error contract
        raise BloscDecodeError("lz4: truncated stream")


def _lz4_block_decompress(src: bytes, dst_size: int) -> bytes:
    out = bytearray()
    pos, end = 0, len(src)
    while pos < end:
        token = src[pos]
        pos += 1
        # literals
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                extra = src[pos]
                pos += 1
                lit_len += extra
                if extra != 255:
                    break
        out += src[pos:pos + lit_len]
        pos += lit_len
        if pos >= end:
            break  # the final sequence is literals-only
        # match copy
        offset = src[pos] | (src[pos + 1] << 8)
        pos += 2
        if offset == 0:
            raise BloscDecodeError("lz4: zero match offset")
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                extra = src[pos]
                pos += 1
                match_len += extra
                if extra != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise BloscDecodeError("lz4: match before start of output")
        # overlapping copies replicate recent output byte-by-byte
        for i in range(match_len):
            out.append(out[start + i])
    if len(out) != dst_size:
        raise BloscDecodeError(
            f"lz4: expected {dst_size} bytes, produced {len(out)}")
    return bytes(out)


def _unshuffle(block: bytes, typesize: int) -> bytes:
    """Invert the blosc byte-shuffle filter on one block."""
    if typesize <= 1:
        return block
    n = len(block)
    body = n - n % typesize
    planes = np.frombuffer(block[:body], dtype=np.uint8)
    restored = planes.reshape(typesize, -1).T.tobytes()
    return restored + block[body:]  # the remainder is stored unshuffled


def _decode_stream(codec: int, payload: bytes, out_size: int) -> bytes:
    if codec == _CODEC_LZ4:
        return lz4_block_decompress(payload, out_size)
    if codec == _CODEC_ZLIB:
        try:
            plain = zlib.decompress(payload)
        except zlib.error as err:
            # keep the documented contract AND let the split-policy retry
            # loop try the other stream layout
            raise BloscDecodeError(f"zlib stream: {err}")
        if len(plain) != out_size:
            raise BloscDecodeError("zlib stream size mismatch")
        return plain
    raise BloscDecodeError(
        f"codec id {codec} is not supported by the pure-Python reader "
        "(lz4 and zlib are)")


def _decode_block(codec: int, src: bytes, out_size: int, nsplits: int) -> bytes:
    """Decode one compressed block laid out as nsplits size-prefixed streams."""
    per_stream = out_size // nsplits
    sizes = [per_stream] * nsplits
    sizes[-1] += out_size - per_stream * nsplits
    pieces = []
    pos = 0
    for want in sizes:
        if pos + 4 > len(src):
            raise BloscDecodeError("truncated stream header")
        (csize,) = struct.unpack_from("<i", src, pos)
        pos += 4
        if csize < 0 or pos + csize > len(src):
            raise BloscDecodeError("stream overruns block")
        chunk = src[pos:pos + csize]
        pos += csize
        if csize == want:
            pieces.append(chunk)  # stored uncompressed
        else:
            pieces.append(_decode_stream(codec, chunk, want))
    return b"".join(pieces)


def blosc_decompress(frame: bytes) -> bytes:
    """Decompress a c-blosc1 frame: native libblosc when present, else the
    pure-Python reader."""
    if _NATIVE is not None:
        return blosc_decompress_native(frame)
    return blosc_decompress_pure(frame)


def blosc_decompress_pure(frame: bytes) -> bytes:
    """Decompress a complete c-blosc1 frame to its original bytes."""
    if len(frame) < HEADER_LEN:
        raise BloscDecodeError("frame shorter than a blosc header")
    _version, _versionlz, flags, typesize = frame[:4]
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", frame, 4)
    if cbytes != len(frame):
        raise BloscDecodeError(
            f"header says {cbytes} bytes, frame has {len(frame)}")
    if flags & _FLAG_BIT_SHUFFLE:
        raise BloscDecodeError("bit-shuffled frames are not supported")
    if nbytes == 0:
        return b""
    if nbytes < 0:
        raise BloscDecodeError(f"negative uncompressed size {nbytes}")

    if flags & _FLAG_MEMCPYED:
        body = frame[HEADER_LEN:HEADER_LEN + nbytes]
        if len(body) != nbytes:
            raise BloscDecodeError("memcpy frame truncated")
        return body

    codec = flags >> _CODEC_SHIFT
    if blocksize <= 0:
        raise BloscDecodeError(f"invalid blocksize {blocksize}")
    n_blocks = (nbytes + blocksize - 1) // blocksize
    if HEADER_LEN + 4 * n_blocks > len(frame):
        raise BloscDecodeError(
            f"frame too short for the {n_blocks}-entry block start table")
    starts = struct.unpack_from(f"<{n_blocks}i", frame, HEADER_LEN)
    if any(s < HEADER_LEN or s >= len(frame) for s in starts):
        raise BloscDecodeError("block start offset outside the frame")

    # the writer's split policy is not recorded in the frame; mirror
    # c-blosc's forward-compatible default and fall back to the other choice
    may_split = (typesize > 1 and typesize <= _MAX_SPLITS
                 and blocksize // typesize >= _MIN_BUFFERSIZE
                 and blocksize % typesize == 0)
    split_orders = (typesize, 1) if may_split else (1,)

    last_err: Exception | None = None
    for nsplits in split_orders:
        try:
            blocks = []
            for bi in range(n_blocks):
                out_size = min(blocksize, nbytes - bi * blocksize)
                # a short trailing block is never split (c-blosc blosc_d)
                block_splits = nsplits if out_size == blocksize else 1
                # streams are size-prefixed, so the block bounds itself;
                # starts need not be ordered
                raw = _decode_block(codec, frame[starts[bi]:], out_size,
                                    block_splits)
                if flags & _FLAG_BYTE_SHUFFLE:
                    raw = _unshuffle(raw, typesize)
                blocks.append(raw)
            return b"".join(blocks)
        except BloscDecodeError as err:
            last_err = err
    raise BloscDecodeError(f"could not decode frame: {last_err}")


def _shuffle(block: bytes, typesize: int) -> bytes:
    """Apply the blosc byte-shuffle filter (inverse of :func:`_unshuffle`)."""
    if typesize <= 1:
        return block
    n = len(block)
    body = n - n % typesize
    planes = np.frombuffer(block[:body], dtype=np.uint8)
    shuffled = planes.reshape(-1, typesize).T.tobytes()
    return shuffled + block[body:]  # the remainder is stored unshuffled


def _memcpy_frame(data: bytes, typesize: int, blocksize: int) -> bytes:
    header = struct.pack("<BBBBiii", 2, 1, _FLAG_MEMCPYED, typesize,
                         len(data), blocksize, len(data) + HEADER_LEN)
    return header + data


def blosc_compress_pure(data: bytes, typesize: int, clevel: int = 3) -> bytes:
    """Build a c-blosc1 frame with pure Python (zlib codec, byte shuffle).

    The layout mirrors what c-blosc itself writes for ``cname='zlib'``:
    zlib never splits blocks (c-blosc's forward-compatible split policy),
    each block is one size-prefixed stream, shuffled before compression,
    stored raw when compression does not shrink it, and the whole frame
    degrades to a memcpy frame when zlib cannot beat the raw size — so the
    reference's python-blosc (the same C library) decodes it.
    """
    nbytes = len(data)
    if typesize <= 0 or typesize > 255 or (nbytes % typesize):
        typesize = 1  # c-blosc conventions (oversize / non-multiple buffers)
    if nbytes == 0:
        return _memcpy_frame(b"", typesize, 0)
    # blocksize: a typesize multiple so whole blocks shuffle/split cleanly
    blocksize = min(max((1 << 20) // typesize, 1) * typesize, nbytes)
    n_blocks = (nbytes + blocksize - 1) // blocksize

    # c-blosc 1.x "forward compatible" split policy: the decompressor
    # re-derives the stream count from (typesize, blocksize), so the writer
    # MUST split identically (mirrors blosc_decompress_pure's may_split)
    may_split = (1 < typesize <= _MAX_SPLITS
                 and blocksize // typesize >= _MIN_BUFFERSIZE
                 and blocksize % typesize == 0)
    nsplits = typesize if may_split else 1

    flags = (_CODEC_ZLIB << _CODEC_SHIFT) | (_FLAG_BYTE_SHUFFLE
                                             if typesize > 1 else 0)
    blocks = []
    for bi in range(n_blocks):
        lo = bi * blocksize
        block = data[lo:lo + blocksize]
        out_size = len(block)
        # a short trailing block is never split (c-blosc blosc_d)
        bsplits = nsplits if out_size == blocksize else 1
        shuf = _shuffle(block, typesize) if typesize > 1 else block
        per = out_size // bsplits
        sizes = [per] * bsplits
        sizes[-1] += out_size - per * bsplits
        parts, pos = [], 0
        for want in sizes:
            seg = shuf[pos:pos + want]
            pos += want
            z = zlib.compress(seg, clevel)
            if len(z) >= want:  # store raw: csize == stream size marks it
                parts.append(struct.pack("<i", want) + seg)
            else:
                parts.append(struct.pack("<i", len(z)) + z)
        blocks.append(b"".join(parts))

    table_end = HEADER_LEN + 4 * n_blocks
    starts, pos = [], table_end
    for b in blocks:
        starts.append(pos)
        pos += len(b)
    cbytes = pos
    if cbytes > nbytes + HEADER_LEN:  # compression did not pay
        return _memcpy_frame(data, typesize, blocksize)
    header = struct.pack("<BBBBiii", 2, 1, flags, typesize, nbytes,
                         blocksize, cbytes)
    return b"".join([header, struct.pack(f"<{n_blocks}i", *starts), *blocks])


def blosc_compress_frame(data: bytes, typesize: int, clevel: int = 3) -> bytes:
    """Compress bytes into a c-blosc1 frame the reference can read: system
    libblosc (lz4 + shuffle, the reference's own settings) when present,
    else the pure-Python zlib-codec writer."""
    if _NATIVE is not None:
        return blosc_compress_native(data, typesize, clevel=clevel)
    return blosc_compress_pure(data, typesize, clevel=clevel)


def compress_reference_dict(arr: np.ndarray, clevel: int = 3,
                            max_blk_size: int = 100_000_000) -> dict:
    """Encode an ndarray as the reference's chunked-blosc array dict
    (pyCamSet ``utils/saving.py:240-295`` layout:
    shape/size/dtype/f/num_chunk/max_num/data/sizes), decodable by the
    reference's ``decompress`` and by :func:`decompress_reference_dict`."""
    import base64

    if arr.dtype == object:
        raise TypeError("dtype object is not implemented")
    shape = arr.shape
    if arr.ndim > 1 and arr.flags["F_CONTIGUOUS"] and not arr.flags["C_CONTIGUOUS"]:
        is_f = True
        flat = np.ascontiguousarray(arr.T).reshape(-1)
    else:
        is_f = False
        flat = np.ascontiguousarray(arr).reshape(-1)

    itemsize = flat.dtype.itemsize
    max_num = max_blk_size // itemsize
    num_chunks = flat.size // max_num
    if flat.size % max_num != 0:
        num_chunks += 1
    data, sizes = [], []
    for ci in range(num_chunks):
        chunk = flat[ci * max_num:(ci + 1) * max_num]
        frame = blosc_compress_frame(chunk.tobytes(), itemsize, clevel)
        sizes.append(len(frame))
        data.append(base64.b64encode(frame).decode())
    return {
        "shape": list(shape),
        "size": int(flat.size),
        "dtype": str(flat.dtype),
        "f": is_f,
        "num_chunk": int(num_chunks),
        "max_num": int(max_num),
        "data": data,
        "sizes": sizes,
    }


def decompress_reference_dict(save_dict: dict) -> np.ndarray:
    """Decode the reference's chunked-blosc array dict
    (pyCamSet ``utils/saving.py:295-332`` layout:
    shape/size/dtype/f/num_chunk/max_num/data/sizes)."""
    import base64

    dtype = np.dtype(save_dict["dtype"])
    flat = np.empty(save_dict["size"], dtype)
    max_num = save_dict["max_num"]
    view = flat.view(np.uint8)
    for ci, chunk_b64 in enumerate(save_dict["data"]):
        plain = blosc_decompress(base64.b64decode(chunk_b64))
        lo = ci * max_num * dtype.itemsize
        view[lo:lo + len(plain)] = np.frombuffer(plain, dtype=np.uint8)
    shape = save_dict["shape"]
    if save_dict.get("f"):
        return flat.reshape(list(shape)[::-1]).T
    return flat.reshape(shape)
