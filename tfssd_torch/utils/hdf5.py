"""Read-only HDF5 reader in numpy, for the subset of the format that h5py
writes by default (its 'earliest' file format, as Keras's model.save and
saving_lib use it); no h5py.

What it reads:

  superblock      version 0, 8-byte offsets and lengths, at byte 0;
  object headers  version 1, continued by continuation messages (0x10);
  groups          symbol-table groups (message 0x11): a version 1 B-tree of
                  group nodes ('TREE', type 0, any height) over symbol-table
                  nodes ('SNOD'), names in the group's local heap ('HEAP');
  datasets        a dataspace (0x01, simple or scalar), a datatype (0x03)
                  and a version 3 layout (0x08), compact or contiguous;
  datatypes       little-endian IEEE float32 / float64, little-endian
                  integers, fixed-length strings and variable-length
                  strings, whose bytes lie in global heap collections
                  ('GCOL');
  attributes      attribute messages (0x0C) of those datatypes.

NIL, fill value, modification time and comment messages are skipped.
Anything else raises a ValueError that names it (another superblock
version, version 2 object headers, link messages and fractal heaps of
new-style groups, dense attribute storage, chunked or filtered layouts,
shared messages, other datatypes), never a partial result.

    f = H5File("model.h5")            # a path, or the file's bytes
    f.keys("/model_weights")          # a group's children, in name order
    f.walk()                          # every object's path, depth-first
    f.read("/a/b/kernel")             # a dataset as a numpy array
    f.attrs("/model_weights")         # {name: value} of an object

Strings come back as str (arrays of them with dtype object); a scalar
attribute comes back as its element, as h5py gives it.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL = 0x00, 0x01, 0x02, \
    0x03, 0x04, 0x05
LINK, EXTERNAL, LAYOUT, GROUP_INFO, FILTERS, ATTRIBUTE = 0x06, 0x07, 0x08, \
    0x0A, 0x0B, 0x0C
COMMENT, MTIME_OLD, CONTINUATION, SYMBOL_TABLE, MTIME = 0x0D, 0x0E, 0x10, \
    0x11, 0x12
ATTRIBUTE_INFO = 0x15
_SKIPPED = {NIL, FILL_OLD, FILL, COMMENT, MTIME_OLD, MTIME}
_REFUSED = {LINK_INFO: "link info (a new-style group)",
            LINK: "a link message (a new-style group)",
            GROUP_INFO: "group info (a new-style group)",
            EXTERNAL: "external data storage",
            FILTERS: "a filter pipeline (filtered layout)",
            ATTRIBUTE_INFO: "attribute info (dense attribute storage in a "
                            "fractal heap)"}

# IEEE layouts of the float sizes read: (exponent location, exponent size,
# mantissa location, mantissa size, exponent bias)
_IEEE = {4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}


class _Type:
    """A datatype: a numpy dtype (numbers), or a string kind: 'fixed' of
    `size` bytes with its padding, or 'vlen' (a 16-byte heap reference)."""

    def __init__(self, size: int, dtype=None, string: str = "",
                 padding: int = 0):
        self.size, self.dtype, self.string, self.padding = (
            size, dtype, string, padding)


def _datatype(body: bytes) -> _Type:
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits = int.from_bytes(body[1:4], "little")
    size = struct.unpack_from("<I", body, 4)[0]
    if version not in (1, 2, 3):
        raise ValueError(f"HDF5 datatype version {version}")
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", body, 8)
        if bits & 1 or size not in (1, 2, 4, 8) or offset or (
                precision != 8 * size):
            raise ValueError(f"HDF5 integer datatype of {size} bytes "
                             f"(bits {bits:#x}, precision {precision}, "
                             f"offset {offset}): only little-endian "
                             f"integers that fill their bytes are read")
        return _Type(size, np.dtype(f"<{'i' if bits & 8 else 'u'}{size}"))
    if cls == 1:  # floating-point
        offset, precision, e_loc, e_size, m_loc, m_size = struct.unpack_from(
            "<HHBBBB", body, 8)
        bias = struct.unpack_from("<I", body, 16)[0]
        if (bits & 0x41 or size not in _IEEE or offset
                or precision != 8 * size
                or (e_loc, e_size, m_loc, m_size, bias) != _IEEE[size]):
            raise ValueError(f"HDF5 float datatype of {size} bytes (bits "
                             f"{bits:#x}): only little-endian IEEE float32 "
                             f"and float64 are read")
        return _Type(size, np.dtype(f"<f{size}"))
    if cls == 3:  # fixed-length string
        return _Type(size, string="fixed", padding=bits & 0x0F)
    if cls == 9:  # variable-length
        if bits & 0x0F != 1:
            raise ValueError("HDF5 variable-length sequence datatype: only "
                             "variable-length strings are read")
        return _Type(size, string="vlen")
    raise ValueError(f"HDF5 datatype class {cls}: only integers, floats and "
                     f"strings are read")


def _dataspace(body: bytes) -> Tuple[int, ...]:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        dims_at = 8
    elif version == 2:
        if body[3] == 2:
            raise ValueError("HDF5 null dataspace")
        dims_at = 4
    else:
        raise ValueError(f"HDF5 dataspace version {version}")
    if flags & 2:
        raise ValueError("HDF5 dataspace with a permutation index")
    return tuple(struct.unpack_from(f"<{rank}Q", body, dims_at))


def _strip(raw: bytes, padding: int) -> str:
    if padding == 0:  # null-terminated
        raw = raw.split(b"\0", 1)[0]
    elif padding == 1:  # null-padded
        raw = raw.rstrip(b"\0")
    elif padding == 2:  # space-padded
        raw = raw.rstrip(b" ")
    else:
        raise ValueError(f"HDF5 string padding {padding}")
    return raw.decode("utf-8")


class H5File:
    """An HDF5 file (a path or its bytes), read whole into memory; groups,
    datasets and attributes are parsed when first asked for."""

    def __init__(self, source: Union[str, os.PathLike, bytes]):
        if isinstance(source, (bytes, bytearray, memoryview)):
            self._data = bytes(source)
            self.name = "<bytes>"
        else:
            self.name = os.fspath(source)
            with open(self.name, "rb") as f:
                self._data = f.read()
        self._headers: Dict[int, List[Tuple[int, bytes]]] = {}
        self._groups: Dict[int, Dict[str, int]] = {}
        self._heaps: Dict[int, Dict[int, bytes]] = {}
        self._root = self._superblock()

    # -- raw bytes --------------------------------------------------------

    def _take(self, pos: int, n: int) -> bytes:
        if pos < 0 or n < 0 or pos + n > len(self._data):
            raise ValueError(f"{self.name}: {n} bytes at {pos} lie beyond "
                             f"the file's {len(self._data)}")
        return self._data[pos:pos + n]

    def _unpack(self, fmt: str, pos: int) -> tuple:
        return struct.unpack(fmt, self._take(pos, struct.calcsize(fmt)))

    def _signature(self, pos: int, sig: bytes, what: str) -> None:
        if self._take(pos, 4) != sig:
            raise ValueError(f"{self.name}: no {what} signature "
                             f"{sig.decode()} at {pos}")

    # -- structure --------------------------------------------------------

    def _superblock(self) -> int:
        """The root group's object header address."""
        if self._data[:8] != SIGNATURE:
            raise ValueError(f"{self.name}: no HDF5 signature at byte 0")
        version = self._data[8]
        if version != 0:
            raise ValueError(f"{self.name}: HDF5 superblock version "
                             f"{version} (only version 0 is read)")
        offsets, lengths = self._data[13], self._data[14]
        if (offsets, lengths) != (8, 8):
            raise ValueError(f"{self.name}: {offsets}-byte offsets and "
                             f"{lengths}-byte lengths (only 8 are read)")
        base = self._unpack("<Q", 24)[0]
        if base != 0:
            raise ValueError(f"{self.name}: base address {base}")
        # the root group's symbol table entry follows the four addresses
        # (base, free space, end of file and one more)
        return self._unpack("<Q", 56 + 8)[0]

    def _messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """(type, body) of every message of the object header at `addr`,
        continuation blocks followed, skipped types left out."""
        if addr in self._headers:
            return self._headers[addr]
        if self._take(addr, 4) == b"OHDR":
            raise ValueError(f"{self.name}: version 2 object header at "
                             f"{addr} (only version 1 is read)")
        version, _, _, _, size = self._unpack("<BBHII", addr)
        if version != 1:
            raise ValueError(f"{self.name}: object header version {version} "
                             f"at {addr}")
        blocks, out = [(addr + 16, size)], []
        while blocks:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end:
                kind, length, flags = self._unpack("<HHB", pos)
                body = self._take(pos + 8, length)
                pos += 8 + length
                if flags & 2:
                    raise ValueError(f"{self.name}: shared message of type "
                                     f"{kind:#x} at {addr}")
                if kind == CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                elif kind in _REFUSED:
                    raise ValueError(f"{self.name}: {_REFUSED[kind]} in the "
                                     f"object header at {addr}")
                elif kind not in _SKIPPED:
                    if kind not in (DATASPACE, DATATYPE, LAYOUT, ATTRIBUTE,
                                    SYMBOL_TABLE):
                        raise ValueError(f"{self.name}: object header "
                                         f"message type {kind:#x} at {addr}")
                    out.append((kind, body))
        self._headers[addr] = out
        return out

    def _find(self, path: str) -> int:
        """The object header address of `path` ('/'-separated, from the
        root)."""
        addr = self._root
        for i, part in enumerate(p for p in path.split("/") if p):
            children = self._children(addr, path)
            if part not in children:
                raise KeyError(f"{self.name}: no object "
                               f"{'/'.join(path.split('/')[:i + 2])!r}")
            addr = children[part]
        return addr

    def _children(self, addr: int, path: str = "") -> Dict[str, int]:
        """{name: object header address} of the group at `addr`."""
        if addr in self._groups:
            return self._groups[addr]
        tables = [b for k, b in self._messages(addr) if k == SYMBOL_TABLE]
        if not tables:
            raise ValueError(f"{self.name}: {path or addr!r} is not a group")
        btree, heap = struct.unpack_from("<QQ", tables[0])
        self._signature(heap, b"HEAP", "local heap")
        names = self._unpack("<Q", heap + 24)[0]
        out: Dict[str, int] = {}
        self._btree(btree, names, out)
        self._groups[addr] = out
        return out

    def _btree(self, addr: int, names: int, out: Dict[str, int]) -> None:
        """Add the symbols under the group B-tree node at `addr`."""
        self._signature(addr, b"TREE", "B-tree")
        kind, level, used = self._unpack("<BBH", addr + 4)
        if kind != 0:
            raise ValueError(f"{self.name}: B-tree node of type {kind} at "
                             f"{addr} where a group node belongs (chunked "
                             f"data?)")
        # keys and children alternate after the two sibling addresses:
        # key 0, child 0, key 1, ..., child used-1, key used
        for i in range(used):
            child = self._unpack("<Q", addr + 24 + 8 + 16 * i)[0]
            if level:
                self._btree(child, names, out)
            else:
                self._symbols(child, names, out)

    def _symbols(self, addr: int, names: int, out: Dict[str, int]) -> None:
        self._signature(addr, b"SNOD", "symbol table node")
        count = self._unpack("<H", addr + 6)[0]
        for i in range(count):
            name_at, header = self._unpack("<QQ", addr + 8 + 40 * i)
            end = self._data.index(b"\0", names + name_at)
            name = self._data[names + name_at:end].decode("utf-8")
            if header == UNDEFINED:
                raise ValueError(f"{self.name}: {name!r} is a soft link")
            out[name] = header

    def _heap_object(self, addr: int, index: int) -> bytes:
        """Object `index` of the global heap collection at `addr`."""
        if addr not in self._heaps:
            self._signature(addr, b"GCOL", "global heap collection")
            size = self._unpack("<Q", addr + 8)[0]
            objects, pos, end = {}, addr + 16, addr + size
            while pos + 16 <= end:
                i, _, _, n = self._unpack("<HHIQ", pos)
                if i == 0:  # the collection's free space
                    break
                objects[i] = self._take(pos + 16, n)
                pos += 16 + (n + 7) // 8 * 8
            self._heaps[addr] = objects
        if index not in self._heaps[addr]:
            raise ValueError(f"{self.name}: no object {index} in the global "
                             f"heap collection at {addr}")
        return self._heaps[addr][index]

    # -- values -----------------------------------------------------------

    def _decode(self, dtype: _Type, shape: Tuple[int, ...], raw: bytes,
                what: str) -> np.ndarray:
        n = int(np.prod(shape, dtype=np.int64))
        if len(raw) < n * dtype.size:
            raise ValueError(f"{self.name}: {what} holds {len(raw)} bytes "
                             f"for {n} elements of {dtype.size}")
        if dtype.dtype is not None:
            return np.frombuffer(raw, dtype.dtype, n).reshape(shape).copy()
        out = np.empty(n, dtype=object)
        for i in range(n):
            cell = raw[i * dtype.size:(i + 1) * dtype.size]
            if dtype.string == "fixed":
                out[i] = _strip(cell, dtype.padding)
            else:
                length, addr, index = struct.unpack_from("<IQI", cell)
                out[i] = (self._heap_object(addr, index)[:length]
                          .decode("utf-8") if length else "")
        return out.reshape(shape)

    def _message(self, messages, kind: int, path: str) -> bytes:
        for k, body in messages:
            if k == kind:
                return body
        raise ValueError(f"{self.name}: {path!r} is not a dataset (no "
                         f"message {kind:#x})")

    # -- the API ----------------------------------------------------------

    def keys(self, path: str = "/") -> List[str]:
        """The names of the group's children, in name order."""
        return sorted(self._children(self._find(path), path))

    def is_group(self, path: str) -> bool:
        return any(k == SYMBOL_TABLE for k, _ in self._messages(
            self._find(path)))

    def walk(self, path: str = "/") -> Iterator[str]:
        """The path of every object below the group `path`, depth-first,
        each group before its children, siblings in name order."""
        for name in self.keys(path):
            child = f"{path.rstrip('/')}/{name}"
            yield child
            if self.is_group(child):
                yield from self.walk(child)

    def read(self, path: str) -> np.ndarray:
        """The dataset at `path`, whole."""
        messages = self._messages(self._find(path))
        shape = _dataspace(self._message(messages, DATASPACE, path))
        dtype = _datatype(self._message(messages, DATATYPE, path))
        layout = self._message(messages, LAYOUT, path)
        if layout[0] != 3:
            raise ValueError(f"{self.name}: {path!r}: layout message "
                             f"version {layout[0]} (only 3 is read)")
        if layout[1] == 0:  # compact: the data follow
            size = struct.unpack_from("<H", layout, 2)[0]
            raw = layout[4:4 + size]
        elif layout[1] == 1:  # contiguous
            addr, size = struct.unpack_from("<QQ", layout, 2)
            if addr == UNDEFINED:
                raise ValueError(f"{self.name}: {path!r} has no storage "
                                 f"allocated")
            raw = self._take(addr, size)
        else:
            raise ValueError(f"{self.name}: {path!r}: "
                             f"{'chunked' if layout[1] == 2 else 'virtual'} "
                             f"layout (only compact and contiguous are read)")
        return self._decode(dtype, shape, raw, path)

    def attrs(self, path: str = "/") -> Dict[str, Any]:
        """{name: value} of every attribute of the object at `path`."""
        out = {}
        for kind, body in self._messages(self._find(path)):
            if kind != ATTRIBUTE:
                continue
            version = body[0]
            name_size, type_size, space_size = struct.unpack_from(
                "<HHH", body, 2)
            if version == 1:
                pos, pad = 8, 8
            elif version in (2, 3):
                if body[1] & 3:
                    raise ValueError(f"{self.name}: {path!r}: attribute with "
                                     f"a shared datatype or dataspace")
                pos, pad = 8 + (version == 3), 1
            else:
                raise ValueError(f"{self.name}: {path!r}: attribute message "
                                 f"version {version}")
            spans = []
            for size in (name_size, type_size, space_size):
                spans.append(body[pos:pos + size])
                pos += (size + pad - 1) // pad * pad
            name = spans[0].split(b"\0", 1)[0].decode("utf-8")
            value = self._decode(_datatype(spans[1]), _dataspace(spans[2]),
                                 body[pos:], f"{path!r} attribute {name!r}")
            out[name] = value[()] if value.ndim == 0 else value
        return out
