"""Read and write the JAX package's checkpoints without msgpack or flax, and
write a run's artifacts (counterpart of caster_dta_tpu/train/checkpoints.py).

Flax writes params with ``flax.serialization.to_bytes``: a msgpack map of
module names down to array leaves. Each array is msgpack ext type 1 whose
payload is itself a msgpack array ``[shape, dtype_name, raw_bytes]``, C order,
little-endian; ext type 3 is a numpy scalar in the same encoding. The reader
and the writer below cover the msgpack subset that such a file uses: maps,
arrays, str, bin, int, float, nil, bool and ext. The writer picks the
smallest encoding of each value, as the msgpack package does, so a param tree
comes out as the bytes ``flax.serialization.to_bytes`` gives.
"""
from __future__ import annotations

import json
import os
import struct
import sys
from typing import Optional

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _bfloat16_to_f32(raw: bytes, shape) -> np.ndarray:
    bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
    return bits.view(np.float32).reshape(shape)


def _decode_ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, raw = _Reader(payload).read()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape = tuple(shape)
    if dtype_name == "bfloat16":  # numpy has no bfloat16: widen exactly to f32
        return _bfloat16_to_f32(raw, shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name).newbyteorder("<")).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k.decode() if isinstance(k, bytes) else k] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = self._take(n)
        if code == _EXT_NDARRAY:
            return _decode_ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _decode_ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        t = self._unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self._take(t & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if t in sized:
            fmt, kind = sized[t]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "str":
                return self._take(n).decode()
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self._ext(fixext[t])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self._unpack(numbers[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def unpackb(data: bytes):
    """Decode one msgpack object (with flax's ndarray ext) from bytes."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after msgpack object")
    return out


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def _sized(self, n: int, small: int | None, codes: tuple) -> None:
        """Header of a sized value: ``small | n`` when a fix form fits, else
        the 8/16/32-bit length form of ``codes`` (None where absent)."""
        if small is not None and n < {0x80: 16, 0x90: 16, 0xA0: 32}[small]:
            self.parts.append(bytes([small | n]))
            return
        for code, fmt in zip(codes, (">B", ">H", ">I")):
            if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
                self.parts.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack value of length {n} is too long")

    def _int(self, v: int) -> None:
        if 0 <= v < 0x80 or -32 <= v < 0:
            self.parts.append(struct.pack(">b" if v < 0 else ">B", v))
            return
        forms = (((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v >= 0 else
                 ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")))
        for code, fmt in forms:
            try:
                self.parts.append(bytes([code]) + struct.pack(fmt, v))
                return
            except struct.error:
                continue
        raise ValueError(f"integer {v} does not fit msgpack")

    def _ext(self, code: int, payload: bytes) -> None:
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            self.parts.append(bytes([fixext[len(payload)]]))
        else:
            self._sized(len(payload), None, (0xC7, 0xC8, 0xC9))
        self.parts.append(struct.pack(">b", code) + payload)

    def write(self, v) -> None:
        if v is None or isinstance(v, bool):
            self.parts.append(bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[v]]))
        elif isinstance(v, (np.ndarray, np.generic)):
            a = np.asarray(v)
            if a.dtype.byteorder == ">":
                a = a.astype(a.dtype.newbyteorder("<"))
            sub = _Writer()
            sub.write([list(a.shape), a.dtype.name, a.tobytes("C")])
            self._ext(_EXT_NPSCALAR if isinstance(v, np.generic) else _EXT_NDARRAY,
                      b"".join(sub.parts))
        elif isinstance(v, int):
            self._int(v)
        elif isinstance(v, float):
            self.parts.append(b"\xcb" + struct.pack(">d", v))
        elif isinstance(v, str):
            raw = v.encode()
            self._sized(len(raw), 0xA0, (0xD9, 0xDA, 0xDB))
            self.parts.append(raw)
        elif isinstance(v, bytes):
            self._sized(len(v), None, (0xC4, 0xC5, 0xC6))
            self.parts.append(v)
        elif isinstance(v, (list, tuple)):
            self._sized(len(v), 0x90, (None, 0xDC, 0xDD))
            for x in v:
                self.write(x)
        elif isinstance(v, dict):
            self._sized(len(v), 0x80, (None, 0xDE, 0xDF))
            for k, x in v.items():
                self.write(str(k))
                self.write(x)
        else:
            raise TypeError(f"cannot write {type(v).__name__} to msgpack")


def packb(obj) -> bytes:
    """Encode nested dicts/lists of numpy arrays, str, bytes, numbers, bool
    and None as msgpack with flax's ndarray ext."""
    w = _Writer()
    w.write(obj)
    return b"".join(w.parts)


def save_params(params: dict, path: str) -> None:
    """Write a JAX-format param tree (for example ``to_jax_params(model)``)
    as a flax ``.msgpack`` checkpoint, atomically."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(packb(params))
    os.replace(tmp, path)


def load_params(path: str) -> dict:
    """A flax ``.msgpack`` checkpoint -> nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return unpackb(f.read())


TRAIN_STATE_FILE = "train_state.msgpack"


def save_train_state(output_folder: str, *, params: dict, opt_state: dict, rng: dict,
                     epoch: int, best_train: float, best_val: float, n_since_best_val: int,
                     lr: float, history: list, scheduler=None) -> None:
    """Write everything a run needs to continue bit for bit, as
    ``output_folder/train_state.msgpack`` (tmp file, then rename: a failure
    mid-write never corrupts the resume point). The msgpack map holds:

    - ``params``: the JAX param tree (``Trainer.params_tree``);
    - ``opt_state``: ``Trainer.opt_state_tree``: ``mu`` and ``nu`` (Adam,
      AdamW) or ``trace`` (SGD with momentum), param trees under the same
      names; ``count``, the optimizer steps taken; ``mini_step``, and with
      gradient accumulation ``acc``, the running mean of the gradients;
    - ``rng``: ``Trainer.rng_state``: ``dropout``, the dropout generator's
      ``get_state()`` bytes (uint8), and ``device``, 'cuda' or 'cpu';
    - ``meta``: ``epoch`` (the last epoch run), ``best_train``, ``best_val``,
      ``n_since_best_val``, ``lr``, ``history`` (JSON text) and ``scheduler``
      (JSON text of the scheduler's plain fields, or null), as the JAX
      package writes them.

    Only ``meta`` has the JAX package's layout. Its ``opt_state`` is optax's
    own state tree and its ``rng`` a JAX key; ``load_train_state`` and
    ``adam_state_from_jax`` read those too, so the port resumes a JAX run,
    but the JAX package does not resume a port run."""
    state = {
        "params": params,
        "opt_state": opt_state,
        "rng": rng,
        "meta": {
            "epoch": int(epoch), "best_train": float(best_train), "best_val": float(best_val),
            "n_since_best_val": int(n_since_best_val), "lr": float(lr),
            "history": json.dumps(history),
            "scheduler": json.dumps(
                {k: v for k, v in vars(scheduler).items()
                 if isinstance(v, (int, float, str, bool))}
                if scheduler is not None else None),
        },
    }
    path = os.path.join(output_folder, TRAIN_STATE_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(state))
    os.replace(tmp, path)


def load_train_state(output_folder: str) -> Optional[dict]:
    """``save_train_state``'s contents (the meta fields at the top level,
    history and scheduler parsed), or None when the folder has none. A file
    the JAX package wrote has its ``opt_state`` as optax wrote it (see
    ``is_jax_opt_state``) and its ``rng`` as ``{"jax_key": uint32 key data,
    "rng_impl": the impl tag or ""}``."""
    path = os.path.join(output_folder, TRAIN_STATE_FILE)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        raw = unpackb(f.read())
    meta = raw["meta"]
    rng = raw["rng"]
    if not isinstance(rng, dict):   # a JAX key: its raw key data and impl tag
        rng = {"jax_key": np.asarray(rng, np.uint32), "rng_impl": raw.get("rng_impl") or ""}
    return {"params": raw["params"], "opt_state": raw["opt_state"], "rng": rng,
            "epoch": int(meta["epoch"]), "best_train": float(meta["best_train"]),
            "best_val": float(meta["best_val"]),
            "n_since_best_val": int(meta["n_since_best_val"]), "lr": float(meta["lr"]),
            "history": json.loads(meta["history"]),
            "scheduler": json.loads(meta["scheduler"])}


def is_jax_opt_state(tree: dict) -> bool:
    """Whether an ``opt_state`` is optax's state tree as the JAX package
    writes it (``flax.serialization.to_state_dict``) rather than the port's
    ``Trainer.opt_state_tree``, which has ``count`` and no optax members."""
    return not ("count" in tree and "inner_state" not in tree and "hyperparams" not in tree)


def adam_state_from_jax(tree: dict) -> dict:
    """The Adam state in a JAX train state's ``opt_state`` -> ``{"kind":
    "adam" | "adamw", "hyperparams": {name: float}, "count": int, "mu":
    moment, "nu": moment}``, each moment a flat f32 vector (optax.flatten,
    the JAX trainer's layout) or a param tree.

    The layouts read are the JAX package's ``make_optimizer`` for "adam"
    without weight decay and "adamw": ``inject_hyperparams`` over a chain
    whose first state holds ``count``, ``mu`` and ``nu`` and whose other
    states are empty, optionally inside ``chain(clip_by_global_norm, ...)``.
    Any other layout (the "adam" chain with L2 weight decay, SGD, MultiSteps
    gradient accumulation) raises ValueError: nothing of it is read."""
    def empty(t):
        return isinstance(t, dict) and all(empty(v) for v in t.values())

    def refuse(why):
        raise ValueError(f"cannot resume from this JAX optimizer state ({why}); the port reads "
                         "optax's Adam and AdamW under inject_hyperparams, optionally after "
                         "clip_by_global_norm")

    if "inner_opt_state" in tree or "acc_grads" in tree:
        refuse("optax.MultiSteps gradient accumulation")
    if set(tree) == {"0", "1"} and empty(tree["0"]):     # chain(clip_by_global_norm, tx)
        tree = tree["1"]
    if "inner_state" not in tree or "hyperparams" not in tree:
        refuse(f"top-level keys {sorted(tree)}")
    inner = tree["inner_state"]
    first = inner.get("0")
    if not isinstance(first, dict) or set(first) != {"count", "mu", "nu"}:
        shown = sorted(first) if isinstance(first, dict) else first
        refuse(f"the first inner state holds {shown}, not Adam's count, mu and nu")
    rest = [k for k in inner if k != "0"]
    if not all(empty(inner[k]) for k in rest) or len(rest) not in (1, 2):
        refuse(f"inner states {sorted(inner)}")
    hyper = {k: float(np.asarray(v)) for k, v in tree["hyperparams"].items()}
    kind = "adamw" if len(rest) == 2 else "adam"
    if ("weight_decay" in hyper) != (kind == "adamw"):
        refuse(f"hyperparams {sorted(hyper)} with {len(inner)} inner states")
    return {"kind": kind, "hyperparams": hyper, "count": int(np.asarray(first["count"])),
            "mu": first["mu"], "nu": first["nu"]}


def unravel_like(vector, template: dict) -> dict:
    """``jax.flatten_util.ravel_pytree``'s unravel: split a flat vector into
    the leaves of ``template`` (a nested dict of arrays) in ``jax.tree_util``
    order, dict keys sorted at every level, each leaf row-major in its
    template's shape. Raises ValueError unless the length is the template's
    size."""
    vector = np.asarray(vector)
    if vector.ndim != 1:
        raise ValueError(f"expected a flat vector, got shape {vector.shape}")
    pos = 0

    def walk(t):
        nonlocal pos
        out = {}
        for k in sorted(t):
            if isinstance(t[k], dict):
                out[k] = walk(t[k])
                continue
            shape = np.shape(t[k])
            n = int(np.prod(shape, dtype=np.int64))
            if pos + n > vector.size:
                raise ValueError(f"a flat vector of {vector.size} entries is shorter than "
                                 "the model's parameters")
            out[k] = vector[pos:pos + n].reshape(shape)
            pos += n
        return out

    out = walk(template)
    if pos != vector.size:
        raise ValueError(f"a flat vector of {vector.size} entries does not match the model's "
                         f"{pos} parameters")
    return out


def get_best_model(checkpoint_path: str, use_best: str = "val") -> str:
    """The best checkpoint file of a run directory, by the reference's name
    prefixes (sorted, first wins), or the path itself when it is a file."""
    if os.path.isdir(checkpoint_path):
        prefixes = {"val": ("bestvalmodel", "bestmodel"),
                    "train": ("besttrainmodel",),
                    "final": ("finalmodel",)}[use_best]
        names = [x for x in sorted(os.listdir(checkpoint_path))
                 if x.startswith(prefixes) and x.endswith(".msgpack")]
        if not names:
            raise FileNotFoundError(f"no {use_best} .msgpack checkpoint in {checkpoint_path}")
        return os.path.join(checkpoint_path, names[0])
    if os.path.isfile(checkpoint_path):
        return checkpoint_path
    raise FileNotFoundError(f"invalid checkpoint path {checkpoint_path}")


def best_checkpoint_name(kind: str, dataset_name: str, loss: float, epoch: int) -> str:
    """bestvalmodel_{ds}_val{loss}_epoch{e:05d}.msgpack and its train and
    final siblings (the reference's train_model.py:672,681,707)."""
    if kind == "val":
        return f"bestvalmodel_{dataset_name}_val{loss:.4f}_epoch{epoch:>05d}.msgpack"
    if kind == "train":
        return f"besttrainmodel_{dataset_name}_train{loss:.4f}_epoch{epoch:>05d}.msgpack"
    if kind == "final":
        return f"finalmodel_{dataset_name}_val{loss:.4f}_epoch{epoch:>05d}.msgpack"
    raise ValueError(kind)


def save_run_artifacts(output_folder: str, dataset_kwargs: dict,
                       rescale_params: Optional[dict], protein_gnn_kwargs: dict,
                       molecule_gnn_kwargs: dict, joint_gnn_kwargs: dict,
                       model_summary: Optional[str] = None) -> None:
    """The reference's artifact set, with its JSON schemas: train_command.txt,
    dataset_kwargs.json, dataset_rescale_params.json, model_kwargs.json and
    an optional model_summary.txt."""
    os.makedirs(output_folder, exist_ok=True)
    with open(os.path.join(output_folder, "train_command.txt"), "w") as f:
        f.write(sys.executable + " " + " ".join(sys.argv))
    with open(os.path.join(output_folder, "dataset_kwargs.json"), "w") as f:
        json.dump(dataset_kwargs, f, indent=4)
    if rescale_params is not None:
        with open(os.path.join(output_folder, "dataset_rescale_params.json"), "w") as f:
            json.dump(rescale_params, f, indent=4)
    with open(os.path.join(output_folder, "model_kwargs.json"), "w") as f:
        json.dump({"protein_gnn_kwargs": protein_gnn_kwargs,
                   "molecule_gnn_kwargs": molecule_gnn_kwargs,
                   "joint_gnn_kwargs": joint_gnn_kwargs}, f, indent=4)
    if model_summary is not None:
        with open(os.path.join(output_folder, "model_summary.txt"), "w") as f:
            f.write(model_summary)


def param_summary(params: dict) -> str:
    """Per-leaf table of a JAX-format param tree, with jax's key-path names."""
    lines, total = [], 0

    def walk(tree, path):
        nonlocal total
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}['{k}']")
                continue
            n = int(np.prod(v.shape)) if v.shape else 1
            total += n
            lines.append(f"{path}['{k}']".ljust(80) + f" {str(v.shape):20s} {n:>10d}")

    walk(params, "")
    lines.append(f"{'TOTAL':80s} {'':20s} {total:>10d}")
    return "\n".join(lines)
