"""Model export and variable save/load (port of ``paddle_tpu/io.py``
:49-470).

The on-disk form is the reference's, so a dir written by either package
loads in the other:

* ``__model__.json``: ``{"program": Program.to_dict(), "feed_names",
  "fetch_names", "feed_specs": {name: {"shape", "dtype"}},
  "format_version": 2}``;
* one ``<quoted var name>.npy`` a variable, or one ``<filename>.npz``
  holding them all (names quoted the same way).

Every file is written atomically (``atomic_write``: a temp file in the
same directory, flushed, fsynced, then ``os.replace``d), so a killed
export never leaves a torn file under its final name.

The reference's ``executor=`` route runs save/load ops through its
executor; the port has no save/load ops and writes from the host in
either case, which gives the same files. ``load_vars`` puts tensors into
the scope on the executor's device when one is given, else on the CPU.
The reference's 2.0 ``save``/``load``, ``get_program_state`` and its
dataset re-exports are not ported.

An int8 weight of a program that ``contrib/slim.convert_to_int8_program``
rewrote keeps its VarDesc (float32, as in the reference's program JSON)
and is stored as an int8 array beside its ``<name>@int8_scale`` vector;
``load_vars`` keeps such an array int8 instead of casting it to the
declared dtype (the reference casts it to fp32, so its int8 lowerings
get fp32 weights after a load).
"""

from __future__ import annotations

import json
import os
import tempfile
import urllib.parse
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.ir import OpDesc, Program, Variable, default_main_program
from .core.registry import EMPTY_VAR
from .core.scope import Scope, global_scope
from .core.types import to_torch_dtype

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "read_inference_model_meta", "prune_program",
    "atomic_write", "atomic_savez", "atomic_save_npy", "atomic_write_json",
]

_MODEL_FILE = "__model__.json"
# the scale vector of an int8 weight (contrib/slim.py)
INT8_SCALE_SUFFIX = "@int8_scale"


def _fsync_dir(path: str):
    """Durably record a directory entry; some filesystems refuse an fsync
    of a directory, which is then skipped."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, writer: Callable, mode: str = "wb") -> str:
    """Call ``writer(f)`` on a temp file in ``path``'s directory, fsync it,
    then replace ``path`` with it. On any failure ``path`` is untouched
    and the temp file removed."""
    path = os.path.abspath(path)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=f".tmp-{os.path.basename(path)}-")
    try:
        with os.fdopen(fd, mode) as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_savez(path: str, **arrays) -> str:
    """np.savez, committed atomically (``.npz`` appended as np.savez
    does)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    return atomic_write(path, lambda f: np.savez(f, **arrays))


def atomic_save_npy(path: str, array) -> str:
    if not path.endswith(".npy"):
        path = path + ".npy"
    return atomic_write(path, lambda f: np.save(f, np.asarray(array)))


def atomic_write_json(path: str, doc) -> str:
    return atomic_write(path, lambda f: json.dump(doc, f), mode="w")


def _encode_name(name: str) -> str:
    """Var names may hold '/', '@', ...: quote them for the filesystem."""
    return urllib.parse.quote(name, safe="")


def _decode_name(fname: str) -> str:
    return urllib.parse.unquote(fname)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        from .core.executor import _to_numpy as tensor_to_numpy

        return tensor_to_numpy(v)
    return np.asarray(v)


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A loaded array as a tensor of the var's dtype on ``device``; a
    bfloat16 array (``ml_dtypes``) is reinterpreted bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=to_torch_dtype(dtype))


# ---------------------------------------------------------------------------
# program pruning (reference: io.py prune_program)
# ---------------------------------------------------------------------------

def prune_program(program: Program, feed_names: Sequence[str],
                  fetch_names: Sequence[str]) -> Program:
    """Backward-slice block 0 of a test clone of ``program`` to the ops
    that compute ``fetch_names`` from ``feed_names`` (and the scope)."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    feed_set = set(feed_names)
    needed = set(fetch_names)
    kept_rev: List[OpDesc] = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_names() if n != EMPTY_VAR):
            kept_rev.append(op)
            for n in op.input_names():
                if n != EMPTY_VAR and n not in feed_set:
                    needed.add(n)
    block.ops = list(reversed(kept_rev))
    used = set(feed_names) | set(fetch_names)
    for op in block.ops:
        used.update(op.input_names())
        used.update(op.output_names())
    block.vars = {n: v for n, v in block.vars.items() if n in used}
    return pruned


# ---------------------------------------------------------------------------
# variable save/load (reference: io.py save_vars / load_vars)
# ---------------------------------------------------------------------------

def _select_vars(program: Program, vars=None, predicate=None
                 ) -> List[Variable]:
    if vars is not None:
        return [program.global_block().var(v) if isinstance(v, str) else v
                for v in vars]
    pred = predicate or (lambda v: True)
    seen: Dict[str, Variable] = {}
    for v in program.list_vars():
        if v.name not in seen and pred(v):
            seen[v.name] = v
    return list(seen.values())


def is_persistable(var: Variable) -> bool:
    return bool(var.persistable)


def is_parameter(var: Variable) -> bool:
    return bool(getattr(var.desc, "is_parameter", False))


def save_vars(executor=None, dirname: str = "",
              main_program: Optional[Program] = None, vars=None,
              predicate=None, filename: Optional[str] = None,
              scope: Optional[Scope] = None) -> List[str]:
    """Write the selected vars to ``dirname``: one ``.npy`` a var, or one
    ``.npz`` when ``filename`` is given. Returns the sorted names."""
    program = main_program or default_main_program()
    scope = global_scope() if scope is None else scope
    os.makedirs(dirname, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for v in _select_vars(program, vars, predicate):
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(
                f"save_vars: variable '{v.name}' has no value in scope — "
                f"run the startup program first")
        arrays[v.name] = _to_numpy(val)
    if filename is not None:
        atomic_savez(os.path.join(dirname, filename),
                     **{_encode_name(k): a for k, a in arrays.items()})
    else:
        for name, a in arrays.items():
            atomic_save_npy(
                os.path.join(dirname, _encode_name(name) + ".npy"), a)
    return sorted(arrays)


def load_vars(executor=None, dirname: str = "",
              main_program: Optional[Program] = None, vars=None,
              predicate=None, filename: Optional[str] = None,
              scope: Optional[Scope] = None) -> List[str]:
    """Read the selected vars from ``dirname`` into ``scope``, each
    checked against its declared shape and cast to its declared dtype, on
    the executor's device (CPU without one)."""
    program = main_program or default_main_program()
    scope = global_scope() if scope is None else scope
    device = executor.device if executor is not None else "cpu"
    stored = None
    if filename is not None:
        path = os.path.join(dirname, filename)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as z:
            stored = {_decode_name(k): z[k] for k in z.files}
    loaded = []
    int8_weights = {n[:-len(INT8_SCALE_SUFFIX)] for blk in program.blocks
                    for n in blk.vars if n.endswith(INT8_SCALE_SUFFIX)}
    for v in _select_vars(program, vars, predicate):
        if stored is not None:
            if v.name not in stored:
                raise RuntimeError(
                    f"load_vars: '{v.name}' missing from {filename}")
            a = stored[v.name]
        else:
            path = os.path.join(dirname, _encode_name(v.name) + ".npy")
            if not os.path.exists(path):
                raise RuntimeError(
                    f"load_vars: file not found for '{v.name}': {path}")
            a = np.load(path)
        if v.shape is not None and (len(v.shape) != len(a.shape) or not all(
                e in (-1, s) for e, s in zip(v.shape, a.shape))):
            raise RuntimeError(
                f"load_vars: shape mismatch for '{v.name}': "
                f"checkpoint {a.shape} vs program {tuple(v.shape)}")
        dtype = "int8" if v.name in int8_weights and a.dtype == np.int8 \
            else v.dtype
        scope.set(v.name, _to_tensor(a, dtype, device))
        loaded.append(v.name)
    return sorted(loaded)


def save_params(executor=None, dirname: str = "", main_program=None,
                filename=None, scope=None):
    return save_vars(executor, dirname, main_program, predicate=is_parameter,
                     filename=filename, scope=scope)


def load_params(executor=None, dirname: str = "", main_program=None,
                filename=None, scope=None):
    return load_vars(executor, dirname, main_program, predicate=is_parameter,
                     filename=filename, scope=scope)


def save_persistables(executor=None, dirname: str = "", main_program=None,
                      filename=None, scope=None):
    """Every persistable var: parameters and optimizer state."""
    return save_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename,
                     scope=scope)


def load_persistables(executor=None, dirname: str = "", main_program=None,
                      filename=None, scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename,
                     scope=scope)


def save(program: Program, model_path: str, scope: Optional[Scope] = None):
    """2.0 ``paddle.static.save`` (reference ``io.py:356``): parameters
    to ``<model_path>.pdparams.npz``, the other persistables (optimizer
    state) to ``.pdopt.npz``, the program's JSON to ``.pdmodel``; the
    reference's files, so either package loads the other's."""
    scope = global_scope() if scope is None else scope
    params = {v.name: _to_numpy(scope.find_var(v.name))
              for v in _select_vars(program, predicate=is_parameter)
              if scope.find_var(v.name) is not None}
    others = {v.name: _to_numpy(scope.find_var(v.name))
              for v in _select_vars(program, predicate=is_persistable)
              if not is_parameter(v) and scope.find_var(v.name) is not None}
    os.makedirs(os.path.dirname(os.path.abspath(model_path)), exist_ok=True)
    atomic_savez(model_path + ".pdparams.npz",
                 **{_encode_name(k): v for k, v in params.items()})
    atomic_savez(model_path + ".pdopt.npz",
                 **{_encode_name(k): v for k, v in others.items()})
    atomic_write_json(model_path + ".pdmodel", program.to_dict())


def load(program: Program, model_path: str, executor=None,
         scope: Optional[Scope] = None):
    """2.0 ``paddle.static.load`` (reference ``io.py:375``): every array
    of ``<model_path>.pdparams.npz`` and ``.pdopt.npz`` into ``scope``,
    as the program declares the var's dtype where it does, on the
    executor's device (CPU without one)."""
    scope = global_scope() if scope is None else scope
    device = executor.device if executor is not None else "cpu"
    block = program.global_block()
    for suffix in (".pdparams.npz", ".pdopt.npz"):
        path = model_path + suffix
        if os.path.exists(path):
            with np.load(path) as z:
                for k in z.files:
                    name = _decode_name(k)
                    a = np.asarray(z[k])
                    dtype = block.var(name).dtype \
                        if block.has_var(name) else a.dtype
                    scope.set(name, _to_tensor(a, dtype, device))


# ---------------------------------------------------------------------------
# inference model export (reference: io.py save_inference_model)
# ---------------------------------------------------------------------------

def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence, executor=None,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope: Optional[Scope] = None) -> List[str]:
    """Export the program pruned to feed -> fetch, with its feed
    signature, and its persistables. Returns the fetch names."""
    program = main_program or default_main_program()
    scope = global_scope() if scope is None else scope
    fetch_names = [t.name if isinstance(t, Variable) else str(t)
                   for t in target_vars]
    inference_program = prune_program(program, feeded_var_names, fetch_names)
    os.makedirs(dirname, exist_ok=True)
    block = inference_program.global_block()
    feed_specs = {n: {"shape": list(block.var(n).shape or ()),
                      "dtype": str(block.var(n).dtype)}
                  for n in feeded_var_names if block.has_var(n)}
    doc = {
        "program": inference_program.to_dict(),
        "feed_names": list(feeded_var_names),
        "fetch_names": fetch_names,
        "feed_specs": feed_specs,
        "format_version": 2,
    }
    atomic_write_json(os.path.join(dirname, model_filename or _MODEL_FILE),
                      doc)
    save_vars(executor, dirname, inference_program, predicate=is_persistable,
              filename=params_filename, scope=scope)
    return fetch_names


def load_inference_model(dirname: str, executor=None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope: Optional[Scope] = None):
    """(program, feed_names, fetch_names); the persistables go into
    ``scope``."""
    scope = global_scope() if scope is None else scope
    with open(os.path.join(dirname, model_filename or _MODEL_FILE)) as f:
        doc = json.load(f)
    program = Program.from_dict(doc["program"])
    load_vars(executor, dirname, program, predicate=is_persistable,
              filename=params_filename, scope=scope)
    return program, doc["feed_names"], doc["fetch_names"]


def read_inference_model_meta(dirname: str,
                              model_filename: Optional[str] = None) -> dict:
    """The model's signature without loading its parameters:
    {feed_names, fetch_names, feed_specs, format_version}. A format 1
    dir (no stored specs) gets its specs from the program's vars."""
    with open(os.path.join(dirname, model_filename or _MODEL_FILE)) as f:
        doc = json.load(f)
    specs = doc.get("feed_specs")
    if specs is None:
        block = Program.from_dict(doc["program"]).global_block()
        specs = {n: {"shape": list(block.var(n).shape or ()),
                     "dtype": str(block.var(n).dtype)}
                 for n in doc["feed_names"] if block.has_var(n)}
    return {"feed_names": list(doc["feed_names"]),
            "fetch_names": list(doc["fetch_names"]),
            "feed_specs": specs,
            "format_version": doc.get("format_version", 1)}
