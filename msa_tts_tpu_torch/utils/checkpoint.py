"""The JAX package's checkpoint and voice files, read and written without
flax or a msgpack package (counterpart of
``msa_tts_tpu/utils/checkpoint.py``).

Those files are ``flax.serialization.msgpack_serialize`` output: a
msgpack map tree with str keys, lists and tuples stored as ``{"0": ...,
"1": ...}`` maps, numpy arrays as ext type 1 (a packed ``(shape, dtype
name, C-order bytes)`` triple), numpy scalars as ext type 3 (the same
triple of a 0-d array) and arrays over 1 GiB split into chunks.  This
module encodes and decodes that subset of msgpack by hand.  Arrays load
as numpy arrays (bfloat16 ones widened to float32), scalars as numpy
scalars.  Writes are atomic (``.tmp``, then a rename);
:class:`AsyncCheckpointer` copies a payload to the host at once and
writes it on a thread (a ``.ckpt``, or a pickle that carries one);
:func:`restore_like` puts a decoded tree back into a template's structure
and tensors; :func:`opt_to_tree` / :func:`opt_from_tree` carry an
optimizer state (``optim.py``) to and from the JAX package's layout.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import weakref
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ------------------------------------------------------------------ encode

def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif 0 <= n <= 0xFF:
        out += b"\xcc" + struct.pack(">B", n)
    elif 0 <= n <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", n)
    elif 0 <= n <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", n)
    elif 0 <= n < 1 << 64:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -0x80 <= n:
        out += b"\xd0" + struct.pack(">b", n)
    elif -0x8000 <= n:
        out += b"\xd1" + struct.pack(">h", n)
    elif -0x80000000 <= n:
        out += b"\xd2" + struct.pack(">i", n)
    elif -(1 << 63) <= n:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"integer out of msgpack's range: {n}")


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple) -> None:
    """A length header: the fix form when it fits, else 8/16/32 bits
    (``codes`` those forms' type bytes; None where there is none)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += bytes([codes[2]]) + struct.pack(">I", n)
    else:
        raise OverflowError(f"msgpack object too long: {n}")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out += b


def _pack_bin(out: bytearray, b: bytes) -> None:
    _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
    out += b


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _array_triple(a: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack array ``[shape, dtype
    name, C-order bytes]``."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes do not serialize")
    out = bytearray()
    _pack_len(out, 3, 0x90, 15, (None, 0xDC, 0xDD))
    _pack_len(out, a.ndim, 0x90, 15, (None, 0xDC, 0xDD))
    for d in a.shape:
        _pack_int(out, int(d))
    _pack_str(out, a.dtype.name)
    _pack_bin(out, np.ascontiguousarray(a).tobytes("C"))
    return bytes(out)


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _array_triple(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_triple(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        _pack_str(out, x)
    elif isinstance(x, (bytes, bytearray)):
        _pack_bin(out, bytes(x))
    elif isinstance(x, dict):
        if not all(isinstance(k, str) for k in x):
            raise TypeError(f"map keys must be str, got {list(x)!r}")
        # in sorted order, as flax's tree copy leaves them
        _pack_len(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k in sorted(x):
            _pack_str(out, k)
            _pack(out, x[k])
    elif isinstance(x, (list, tuple)):
        # flax's to_state_dict: a sequence is a map of its indices
        _pack(out, {str(i): v for i, v in enumerate(x)})
    elif hasattr(x, "detach"):              # a torch tensor
        _pack(out, x.detach().cpu().numpy())
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def serialize_payload(payload: dict) -> bytes:
    """A tree of dicts (str keys), lists, tuples, arrays (numpy or
    torch), numpy scalars and Python scalars → the bytes flax's
    ``msgpack_serialize`` gives for it after ``to_state_dict``."""
    out = bytearray()
    _pack(out, payload)
    return bytes(out)


# ------------------------------------------------------------------ decode

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",        # bin
        0xD9: ">B", 0xDA: ">H", 0xDB: ">I",        # str
        0xDC: ">H", 0xDD: ">I",                    # array
        0xDE: ">H", 0xDF: ">I",                    # map
        0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}        # ext
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _unpack(r: _Reader, ext_hook):
    t = r.unpack(">B")
    if t < 0x80:
        return t
    if t >= 0xE0:
        return t - 0x100
    if t < 0x90:
        return _map(r, t & 0x0F, ext_hook)
    if t < 0xA0:
        return [_unpack(r, ext_hook) for _ in range(t & 0x0F)]
    if t < 0xC0:
        return str(r.take(t & 0x1F), "utf-8")
    if t == 0xC0:
        return None
    if t in (0xC2, 0xC3):
        return t == 0xC3
    if t in _FIXED:
        return r.unpack(_FIXED[t])
    if t in _FIXEXT:
        code = r.unpack(">b")
        return ext_hook(code, bytes(r.take(_FIXEXT[t])))
    if t not in _LEN:
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")
    n = r.unpack(_LEN[t])
    if t in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(n))
    if t in (0xD9, 0xDA, 0xDB):
        return str(r.take(n), "utf-8")
    if t in (0xDC, 0xDD):
        return [_unpack(r, ext_hook) for _ in range(n)]
    if t in (0xDE, 0xDF):
        return _map(r, n, ext_hook)
    code = r.unpack(">b")
    return ext_hook(code, bytes(r.take(n)))


def _map(r: _Reader, n: int, ext_hook) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, ext_hook)
        out[k] = _unpack(r, ext_hook)
    return out


def _decode(data: bytes, ext_hook=None):
    r = _Reader(data)
    out = _unpack(r, ext_hook or _no_ext)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _no_ext(code, data):
    raise ValueError(f"unexpected msgpack ext type {code}")


def _array_from_triple(data: bytes) -> np.ndarray:
    shape, name, buf = _decode(data)
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_triple(data)
    if code == _EXT_NPSCALAR:
        return _array_from_triple(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(tree):
    """flax splits arrays over 1 GiB into ``__msgpack_chunked_array__``
    maps; join them back."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def deserialize_payload(data: bytes) -> dict:
    """flax ``msgpack_restore``: bytes → a tree of dicts, arrays and
    scalars (sequences stay ``{"0": ...}`` maps)."""
    return _unchunk(_decode(data, _ext))


# -------------------------------------------------------------------- files

def save_checkpoint(path: str, payload: dict) -> None:
    """Write ``payload`` atomically: to ``path + ".tmp"``, then rename."""
    data = serialize_payload(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return deserialize_payload(f.read())


def load_model_checkpoint(path: str, cfg) -> tuple[dict, str]:
    """A Tacotron-2 checkpoint as the model's reference-layout
    ``state_dict`` (CPU tensors, for ``load_state_dict(strict=True)``)
    and the file it came from.

    ``path`` names the file, or its stem: then ``<path>.ckpt`` (a
    trainer's msgpack checkpoint of either package: its ``params`` and
    ``model_state``) is read if it exists, else ``<path>.pt`` (a
    reference ``state_dict``).  Raises ``FileNotFoundError`` when
    neither exists."""
    import torch

    from .convert import state_dict_from_jax

    paths = ([path] if path.endswith((".ckpt", ".pt"))
             else [path + ".ckpt", path + ".pt"])
    for p in paths:
        if not os.path.exists(p):
            continue
        if p.endswith(".ckpt"):
            raw = load_checkpoint(p)
            return state_dict_from_jax(raw["params"], raw["model_state"],
                                       cfg), p
        return torch.load(p, map_location="cpu", weights_only=True), p
    raise FileNotFoundError(" or ".join(paths))


def _host_copy(tree):
    """A snapshot of a payload tree on the host: every tensor copied to a
    numpy array now, so that later in-place updates of the tensors do
    not reach a write that is still pending."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_copy(v) for v in tree]
    if hasattr(tree, "detach"):
        return tree.detach().to("cpu", copy=True).numpy()
    return tree


def restore_like(template, restored):
    """``restored`` (a decoded tree: sequences as ``{"0": ...}`` maps) in
    the structure of ``template``: dicts by key, lists and tuples by
    index, tensors in the template tensor's type and device, None where
    the template has None (the file holds an empty map there)."""
    import torch

    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(restored), dtype=template.dtype,
                               device=template.device)
    if isinstance(template, dict):
        missing = [k for k in template if k not in restored]
        if missing:
            raise KeyError(f"checkpoint lacks {missing}")
        return {k: restore_like(v, restored[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = [restore_like(v, restored[str(i)])
                 for i, v in enumerate(template)]
        return (type(template)(*items) if hasattr(template, "_fields")
                else type(template)(items))
    if isinstance(template, np.ndarray):
        return np.asarray(restored, dtype=template.dtype)
    return type(template)(restored)


def opt_to_tree(state, names: set, to_tree):
    """An optimizer state (``optim.py``) as the JAX package's checkpoint
    holds it: per-parameter dictionaries (keyed by ``names``) through
    ``to_tree``, empty states as ``{}``."""
    if state is None:
        return {}
    if isinstance(state, dict):
        if state.keys() == names:
            return to_tree(state)
        return {k: opt_to_tree(v, names, to_tree) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [opt_to_tree(v, names, to_tree) for v in state]
    return state


def opt_from_tree(template, raw, names: set, from_tree):
    """The inverse of :func:`opt_to_tree` in ``template``'s structure,
    types and device (``from_tree``: a checkpoint's per-parameter tree →
    ``{name: tensor}``)."""
    if isinstance(template, dict):
        if template.keys() == names:
            sd = from_tree(raw)
            return restore_like(template, {k: sd[k] for k in template})
        return {k: opt_from_tree(v, raw[k], names, from_tree)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(opt_from_tree(v, raw[str(i)], names, from_tree)
                              for i, v in enumerate(template))
    return restore_like(template, raw)


def load_partial_params(params: dict, ckpt_params: dict, *,
                        verbose: bool = True) -> dict:
    """Parameter-by-parameter load that keeps the current value where the
    checkpoint lacks a name or its shape differs (the reference's
    finetuning behaviour)."""
    import torch

    out = {}
    for name, value in params.items():
        new = ckpt_params.get(name)
        if new is not None and tuple(new.shape) == tuple(value.shape):
            out[name] = torch.as_tensor(new, dtype=value.dtype,
                                        device=value.device)
        else:
            if verbose:
                print(f"Could not load weights for {name}")
            out[name] = value
    return out


_LIVE_CHECKPOINTERS: "weakref.WeakSet" = weakref.WeakSet()


def wait_all_checkpoints() -> None:
    """Drain every live :class:`AsyncCheckpointer`: call before reading
    files that a trainer in this process may still be writing."""
    for c in list(_LIVE_CHECKPOINTERS):
        c.wait()


class AsyncCheckpointer:
    """Background checkpoint writer: ``save`` copies the payload to the
    host at once (the trainer updates its tensors in place afterwards),
    and a worker thread encodes and writes it (``.tmp``, then an atomic
    rename).  Writes are FIFO on one worker; a worker's error is raised
    by the next ``save`` or ``wait``."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                         name="async-checkpoint")
        self._thread.start()
        _LIVE_CHECKPOINTERS.add(self)

    def _loop(self):
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                fn()
            except BaseException as e:  # re-raised by the next save/wait
                self._error = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, path: str, payload: dict) -> None:
        """Snapshot ``payload`` to the host now; encode and write later."""
        self._check()
        host = _host_copy(payload)
        self._q.put(lambda: save_checkpoint(path, host))

    def save_pickle(self, path: str, obj: dict, *,
                    ckpt_payload: dict | None = None,
                    ckpt_key: str = "ckpt") -> None:
        """Pickle ``obj`` to ``path`` later, with (``ckpt_payload``) the
        ``.ckpt`` bytes of that payload under ``obj[ckpt_key]``: one atomic
        file carrying a checkpoint and its metadata.  ``obj`` is deep-
        copied and the payload copied to the host now, so that the file
        holds the state at this call."""
        import copy
        import pickle

        self._check()
        obj = copy.deepcopy(obj)
        host = _host_copy(ckpt_payload) if ckpt_payload is not None else None

        def write():
            out = obj
            if host is not None:
                out = dict(obj, **{ckpt_key: serialize_payload(host)})
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, path)

        self._q.put(write)

    def wait(self) -> None:
        """Block until every pending write has landed; raise its error."""
        self._q.join()
        self._check()

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
