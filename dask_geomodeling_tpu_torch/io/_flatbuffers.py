"""The part of the FlatBuffers runtime that FlatGeobuf needs.

The JAX package's io/flatgeobuf.py reads and builds its header and
feature tables with the ``flatbuffers`` package; the port has no such
dependency, so this module holds the subset of that runtime's Python
implementation (version 25.12.19) its FlatGeobuf code calls:

- ``Table``: a table at a position of a little-endian buffer, the
  runtime's ``flatbuffers.table.Table``; a field is found through the
  table's vtable, and ``field``, ``scalar``, ``string``, ``vector``,
  ``tables`` and ``table`` read it as the runtime's ``Offset``, ``Get``,
  ``String``, ``Vector``/``VectorLen`` and ``Indirect`` do;
- ``Builder``: the runtime's ``flatbuffers.Builder``, building back to
  front with its alignment (its ``Prep``), its vtable deduplication and
  its rule that a slot whose value equals its default is not written, so
  that a buffer built by the same calls is byte-identical to the
  runtime's.  Only the calls FlatGeobuf's writer makes are here.
"""
import struct

import numpy as np

__all__ = ["Table", "Builder", "root"]

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")


class Table:
    """A table at ``pos`` of ``buf`` (bytes or a memoryview)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos):
        self.buf = buf
        self.pos = pos

    def field(self, slot):
        """The field's offset from the table, 0 when it is absent."""
        vtable = self.pos - _I32.unpack_from(self.buf, self.pos)[0]
        at = 4 + 2 * slot
        if at < _U16.unpack_from(self.buf, vtable)[0]:
            return _U16.unpack_from(self.buf, vtable + at)[0]
        return 0

    def scalar(self, slot, fmt, default):
        """The scalar of struct format ``fmt`` in the slot, or ``default``."""
        o = self.field(slot)
        if not o:
            return default
        return struct.unpack_from(fmt, self.buf, self.pos + o)[0]

    def _target(self, o):
        at = self.pos + o
        return at + _U32.unpack_from(self.buf, at)[0]

    def string(self, slot):
        o = self.field(slot)
        if not o:
            return None
        at = self._target(o)
        length = _U32.unpack_from(self.buf, at)[0]
        return bytes(self.buf[at + 4 : at + 4 + length]).decode("utf-8")

    def vector(self, slot):
        """(start, length) of the vector in the slot, or None."""
        o = self.field(slot)
        if not o:
            return None
        at = self._target(o)
        return at + 4, _U32.unpack_from(self.buf, at)[0]

    def array(self, slot, dtype):
        """A vector of numbers as a numpy array over the buffer, or None."""
        vector = self.vector(slot)
        if vector is None:
            return None
        start, length = vector
        return np.frombuffer(self.buf, dtype=dtype, count=length, offset=start)

    def byte_vector(self, slot):
        """The bytes of a vector of bytes, b"" when it is absent."""
        vector = self.vector(slot)
        if vector is None:
            return b""
        start, length = vector
        return bytes(self.buf[start : start + length])

    def tables(self, slot):
        """The tables of a vector of tables, [] when it is absent."""
        vector = self.vector(slot)
        if vector is None:
            return []
        start, length = vector
        out = []
        for i in range(length):
            elem = start + 4 * i
            out.append(Table(self.buf, elem + _U32.unpack_from(self.buf, elem)[0]))
        return out

    def table(self, slot):
        """The table in the slot, or None."""
        o = self.field(slot)
        return Table(self.buf, self._target(o)) if o else None


def root(buf):
    """The root table of a finished buffer."""
    return Table(buf, _U32.unpack_from(buf, 0)[0])


class Builder:
    """flatbuffers.Builder's back-to-front construction, for the calls of
    FlatGeobuf's writer; ``offset`` counts from the buffer's end."""

    def __init__(self, size=1024):
        self.buf = bytearray(size)
        self.head = size
        self.minalign = 1
        self.vtable = None
        self.object_end = 0
        self.vtables = {}
        self.count = 0

    def offset(self):
        return len(self.buf) - self.head

    def _grow(self):
        size = len(self.buf)
        grown = max(size * 2, 1)
        self.buf = bytearray(grown - size) + self.buf
        self.head += grown - size

    def _pad(self, n):
        self.head -= n
        self.buf[self.head : self.head + n] = bytes(n)

    def _prep(self, size, additional):
        """Align so that ``size`` bytes can follow ``additional`` more."""
        self.minalign = max(self.minalign, size)
        align = -(len(self.buf) - self.head + additional) & (size - 1)
        while self.head < align + size + additional:
            self._grow()
        self._pad(align)

    def _place(self, fmt, value):
        self.head -= struct.calcsize(fmt)
        struct.pack_into(fmt, self.buf, self.head, value)

    def _prepend(self, fmt, value):
        self._prep(struct.calcsize(fmt), 0)
        self._place(fmt, value)

    def _put(self, payload):
        self.head -= len(payload)
        self.buf[self.head : self.head + len(payload)] = payload

    # --- vectors and strings ---

    def StartVector(self, elem_size, count, alignment):
        self._prep(4, elem_size * count)
        self._prep(alignment, elem_size * count)
        self.count = count
        return self.offset()

    def EndVector(self):
        self._place("<I", self.count)
        return self.offset()

    def CreateString(self, text):
        payload = text.encode("utf-8")
        self._prep(4, len(payload) + 1)
        self._place("<B", 0)
        self._put(payload)
        self.count = len(payload)
        return self.EndVector()

    def CreateByteVector(self, payload):
        self._prep(4, len(payload))
        self._put(payload)
        self.count = len(payload)
        return self.EndVector()

    def CreateNumpyVector(self, values):
        self.StartVector(values.itemsize, values.size, values.dtype.alignment)
        self._put(values.astype(values.dtype.newbyteorder("<"), copy=False).tobytes())
        self.count = values.size
        return self.EndVector()

    def PrependUOffsetTRelative(self, off):
        self._prep(4, 0)
        self._place("<I", self.offset() - off + 4)

    def PrependFloat64(self, value):
        self._prepend("<d", value)

    # --- tables ---

    def StartObject(self, fields):
        self.vtable = [0] * fields
        self.object_end = self.offset()

    def _slot(self, slot):
        self.vtable[slot] = self.offset()

    def _prepend_slot(self, fmt, slot, value, default):
        if value != default:
            self._prepend(fmt, value)
            self._slot(slot)

    def PrependUint8Slot(self, slot, value, default):
        self._prepend_slot("<B", slot, value, default)

    def PrependUint16Slot(self, slot, value, default):
        self._prepend_slot("<H", slot, value, default)

    def PrependInt32Slot(self, slot, value, default):
        self._prepend_slot("<i", slot, value, default)

    def PrependUint64Slot(self, slot, value, default):
        self._prepend_slot("<Q", slot, value, default)

    def PrependUOffsetTRelativeSlot(self, slot, off, default):
        if off != default:
            self.PrependUOffsetTRelative(off)
            self._slot(slot)

    def EndObject(self):
        """The table's vtable, or the offset of an equal one written
        before (the runtime's key: the field offsets from the last
        present slot down, then the object's size)."""
        self._prep(4, 0)
        self._place("<i", 0)  # the vtable offset, patched below
        table = self.offset()
        present = [k for k, at in enumerate(self.vtable) if at]
        used = self.vtable[: present[-1] + 1] if present else []
        fields = [table - at if at else 0 for at in used]
        size = table - self.object_end
        key = tuple(reversed(fields)) + (size,)
        earlier = self.vtables.get(key)
        if earlier is None:
            for value in reversed(fields):
                self._prepend("<H", value)
            self._prepend("<H", size)
            self._prepend("<H", (len(fields) + 2) * 2)
            # the buffer may have grown: the table's index is taken now
            struct.pack_into("<i", self.buf, len(self.buf) - table, self.offset() - table)
            self.vtables[key] = self.offset()
        else:
            struct.pack_into("<i", self.buf, self.head, earlier - table)
        self.vtable = None
        return table

    def Finish(self, root_table):
        self._prep(self.minalign, 4)
        self.PrependUOffsetTRelative(root_table)
        return self.head

    def Output(self):
        return self.buf[self.head :]
