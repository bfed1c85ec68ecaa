"""Read-only reader of the OCDBT key-value store that orbax writes
(tensorstore's "ocdbt" driver), as far as the committed checkpoints use it;
no tensorstore, no orbax. A frozen copy of tfssd_torch/utils/ocdbt.py.

A store is a directory (an orbax checkpoint's `default/`, or its
`ocdbt.process_<i>/`) that holds:

  manifest.ocdbt  the configuration and the version tree's newest leaf:
                  for each version its generation number and the location
                  of its B-tree's root;
  d/<id>          data files: B-tree nodes and the values too large to sit
                  inline in a leaf, located by (file, offset, length).

Every manifest and node is one encoded file region: a magic number (uint32
big-endian), its length in bytes (uint64 little-endian), a format version
and a compression format (varints: 0, and 0 for none or 1 for zstd), the
body (one zstd frame when compressed), and a CRC-32C of everything before
it (uint32 little-endian). Inside a body, integers are LEB128 varints,
lists are stored column by column, and keys are prefix-compressed (the
length each shares with the one before, then the rest). A node's keys
omit the prefix common to its whole subtree, which its parent holds.

`OcdbtStore(directory).read(key)` gives a value's bytes; `keys()` lists
them in order. The newest version is read; older versions and the
"numbered" manifest kind (which orbax does not write) are not.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple, Union

from portbench.ckpt import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_NAME = "manifest.ocdbt"

_CRC32C_POLY = 0x82F63B78
_CRC_TABLE: List[int] = []

# A value: its bytes (inline) or where they lie: (data file, offset, length).
Ref = Tuple[str, int, int]
Value = Union[bytes, Ref]


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the store's checksums."""
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    table, crc = _CRC_TABLE, 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads a decoded body front to back."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("OCDBT body ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError("OCDBT varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def prefixed(self, n: int, with_column: bool = False
                 ) -> Tuple[List[bytes], List[int]]:
        """`n` prefix-compressed byte strings, and (`with_column`) the
        column of `n` varints that lies between their lengths and their
        bytes."""
        shared = [0] + self.varints(n - 1) if n else []
        sizes = self.varints(n)
        column = self.varints(n) if with_column else []
        out, prev = [], b""
        for keep, size in zip(shared, sizes):
            if keep > len(prev):
                raise ValueError("OCDBT prefix longer than its predecessor")
            prev = prev[:keep] + self.take(size)
            out.append(prev)
        return out, column

    def data_files(self) -> List[str]:
        """A data file table: each file's path (its base path and its
        relative path, concatenated, as both are under the store)."""
        # the column: the base path's share of each path
        paths, _ = self.prefixed(self.varint(), with_column=True)
        return [p.decode() for p in paths]

    def ref(self, files: List[str], n: int) -> List[Ref]:
        """`n` node locations, column by column: file, offset, length."""
        ids, offsets, lengths = (self.varints(n) for _ in range(3))
        if any(i >= len(files) for i in ids):
            raise ValueError("OCDBT data file index out of range")
        return [(files[i], o, s) for i, o, s in zip(ids, offsets, lengths)]


def decode_region(data: bytes, magic: int, what: str) -> bytes:
    """The body of one encoded manifest or node, checked (magic, length,
    CRC-32C, version) and decompressed."""
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"{what}: not an OCDBT region (magic)")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise ValueError(f"{what}: length field does not match")
    if struct.unpack("<I", data[-4:])[0] != crc32c(data[:-4]):
        raise ValueError(f"{what}: CRC-32C does not match")
    head = _Cursor(data[:-4])
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}")
    body = data[head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"{what}: compression format {compression}")


class OcdbtStore:
    """The newest version of the OCDBT store in `directory`: every key and
    where its value lies, read once at construction."""

    def __init__(self, directory: str):
        self.directory = os.fspath(directory)
        root = self._manifest()
        self._values: Dict[bytes, Value] = {}
        # the B-tree's height above its leaves (None: no keys)
        self.root_height = None if root is None else root[1]
        if root is not None:
            self._walk(*root, prefix=b"")

    def _read(self, ref: Ref) -> bytes:
        path, offset, length = ref
        with open(os.path.join(self.directory, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: {len(data)} of {length} bytes at "
                             f"{offset}")
        return data

    def _manifest(self) -> Optional[Tuple[Ref, int]]:
        """(root location, root height) of the newest version, or None for
        a store with no keys."""
        path = os.path.join(self.directory, MANIFEST_NAME)
        with open(path, "rb") as f:
            cur = _Cursor(decode_region(f.read(), MANIFEST_MAGIC, path))
        cur.take(16)  # the store's uuid
        kind = cur.varint()
        if kind != 0:
            raise ValueError(f"{path}: manifest kind {kind} (only 'single', "
                             f"0, is read)")
        cur.varints(2)  # max inline value bytes, max decoded node bytes
        cur.byte()  # version tree arity (log2)
        if cur.varint() == 1:  # the compression method is zstd: its level
            cur.take(4)
        files = cur.data_files()
        n = cur.varint()
        if n == 0:
            return None
        generations = cur.varints(n)
        heights = [cur.byte() for _ in range(n)]
        roots = cur.ref(files, n)
        num_keys = cur.varints(n)
        newest = max(range(n), key=generations.__getitem__)
        if num_keys[newest] == 0:
            return None
        return roots[newest], heights[newest]

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        """Index the subtree at `ref`, whose keys all start with `prefix`."""
        what = f"{ref[0]}@{ref[1]}"
        cur = _Cursor(decode_region(self._read(ref), NODE_MAGIC, what))
        if cur.byte() != height:
            raise ValueError(f"{what}: node height differs from its parent's")
        files = cur.data_files()
        n = cur.varint()
        if height == 0:
            keys = [prefix + k for k in cur.prefixed(n)[0]]
            lengths = cur.varints(n)
            indirect = cur.varints(n)
            m = sum(indirect)
            ids, offsets = cur.varints(m), cur.varints(m)
            if any(i >= len(files) for i in ids):
                raise ValueError(f"{what}: data file index out of range")
            far = iter(zip(ids, offsets))
            for key, length, kind in zip(keys, lengths, indirect):
                if kind not in (0, 1):
                    raise ValueError(f"{what}: value kind {kind}")
                if kind:
                    i, offset = next(far)
                    self._values[key] = (files[i], offset, length)
                else:
                    self._values[key] = cur.take(length)
        else:
            # an interior entry's key is its subtree's first; the column
            # between the key lengths and the key bytes is the length of
            # the prefix common to the subtree, which its node omits
            keys, common = cur.prefixed(n, with_column=True)
            children = cur.ref(files, n)
            cur.varints(3 * n)  # per child: keys, tree bytes, value bytes
            for key, keep, child in zip(keys, common, children):
                self._walk(child, height - 1, prefix + key[:keep])
        if cur.pos != len(cur.data):
            raise ValueError(f"{what}: {len(cur.data) - cur.pos} bytes left "
                             f"after the node's entries")

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def __contains__(self, key) -> bool:
        return _key(key) in self._values

    def read(self, key) -> Optional[bytes]:
        """The value of `key` (bytes or str), or None where it is absent."""
        value = self._values.get(_key(key))
        if value is None or isinstance(value, bytes):
            return value
        return self._read(value)


def _key(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)
