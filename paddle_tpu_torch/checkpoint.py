"""Published models: atomic versioned publishing of inference-model dirs
and the watcher behind the rolling swap (port of the published-model
part of ``paddle_tpu/checkpoint.py``: ``list_model_versions`` :537,
``publish_model`` :556, ``verify_model_dir`` :623, ``ModelWatcher``
:662).

``publish_model(root, src)`` copies an ``io.save_inference_model`` dir
into a staging dir under ``root``, fsyncs every file, writes the COMMIT
manifest last (``MANIFEST.json``: format, version, per-file sha256 and
size, the commit marker) and renames the staging dir to
``model-<version:06d>`` in one step. A watcher that polls the root sees a
version complete and verified, or not at all. The manifest's format is
the reference's, so a dir published by either package verifies in the
other.

The training checkpoint (``CheckpointManager``, ``save_checkpoint``,
the async writer) is ROADMAP A9.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .core import flags as _flags
from .core import telemetry
from .io import _fsync_dir

MANIFEST_NAME = "MANIFEST.json"
MODEL_FORMAT = "paddle_tpu-model-v1"
_MODEL_PREFIX = "model-"
_TMP_MODEL_PREFIX = ".tmp-model-"


class CheckpointError(RuntimeError):
    """Base of the publish protocol's failures."""


class CheckpointCorruptError(CheckpointError):
    """A published dir failed verification (torn write, bit rot, an
    uncommitted staging dir, a manifest mismatch)."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def list_model_versions(models_root: str) -> List[Tuple[int, str]]:
    """[(version, path)] of the dirs named like a committed version,
    ascending. Only the name is checked: ``verify_model_dir`` judges the
    contents."""
    out = []
    try:
        names = os.listdir(models_root)
    except OSError:
        return out
    for name in names:
        if not name.startswith(_MODEL_PREFIX):
            continue
        try:
            version = int(name[len(_MODEL_PREFIX):])
        except ValueError:
            continue
        out.append((version, os.path.join(models_root, name)))
    return sorted(out)


def publish_model(models_root: str, src_dir: str,
                  version: Optional[int] = None,
                  extras: Optional[Dict[str, Any]] = None) -> str:
    """Publish the inference-model dir ``src_dir`` as
    ``<models_root>/model-<version>/`` with a COMMIT manifest, atomically.
    ``version`` defaults to the newest on disk + 1; a published version
    is immutable. Returns the final dir."""
    t0 = time.perf_counter()
    models_root = os.path.abspath(models_root)
    os.makedirs(models_root, exist_ok=True)
    if version is None:
        published = list_model_versions(models_root)
        version = (published[-1][0] + 1) if published else 1
    version = int(version)
    final_dir = os.path.join(models_root, f"{_MODEL_PREFIX}{version:06d}")
    names = sorted(n for n in os.listdir(src_dir)
                   if os.path.isfile(os.path.join(src_dir, n)))
    if not names:
        raise ValueError(f"{src_dir}: no model files to publish")
    tmp = os.path.join(models_root,
                       f"{_TMP_MODEL_PREFIX}{version:06d}"
                       f"-{os.getpid()}-{threading.get_ident()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        files = {}
        for name in names:
            dst = os.path.join(tmp, name)
            shutil.copyfile(os.path.join(src_dir, name), dst)
            with open(dst, "rb") as f:
                os.fsync(f.fileno())
            files[name] = {"sha256": _sha256_file(dst),
                           "nbytes": os.path.getsize(dst)}
        manifest = {"format": MODEL_FORMAT, "version": version,
                    "ts": time.time(), "files": files,
                    "extras": dict(extras or {}), "committed": True}
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final_dir):
            raise CheckpointError(
                f"{final_dir}: model version {version} already published "
                f"(versions are immutable — publish a new one)")
        os.rename(tmp, final_dir)
        _fsync_dir(models_root)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    telemetry.counter_add("serving.models_published", 1)
    telemetry.observe("ckpt.publish_ms", (time.perf_counter() - t0) * 1e3)
    return final_dir


def verify_model_dir(path: str, deep: Optional[bool] = None
                     ) -> Dict[str, Any]:
    """Check a published dir's COMMIT manifest and, with deep
    verification (``FLAGS_ckpt_verify``, on by default), every file's
    size and sha256. Raises CheckpointCorruptError; returns the
    manifest."""
    if deep is None:
        deep = bool(_flags.flag("ckpt_verify"))
    if not os.path.isdir(path):
        raise CheckpointCorruptError(f"{path}: not a model directory")
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(
            f"{path}: no {MANIFEST_NAME} — publish never committed")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest: {e}")
    if manifest.get("format") != MODEL_FORMAT:
        raise CheckpointCorruptError(
            f"{path}: unknown model format {manifest.get('format')!r}")
    if not manifest.get("committed"):
        raise CheckpointCorruptError(f"{path}: manifest lacks commit marker")
    for name, spec in (manifest.get("files") or {}).items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            raise CheckpointCorruptError(
                f"{path}: model file '{name}' missing")
        if deep:
            nbytes = os.path.getsize(fpath)
            if nbytes != int(spec.get("nbytes", -1)):
                raise CheckpointCorruptError(
                    f"{path}: torn model file '{name}' ({nbytes} bytes, "
                    f"manifest says {spec.get('nbytes')})")
            if _sha256_file(fpath) != spec.get("sha256"):
                raise CheckpointCorruptError(
                    f"{path}: sha256 mismatch for model file '{name}'")
    return manifest


class ModelWatcher:
    """Poll a models root for newly published verified versions.

    ``latest()`` is the newest (version, path) whose manifest verifies;
    an unverifiable one is skipped (``serving.model_rejected``) for the
    next newest. ``poll()`` returns it only when it is newer than the
    last version this watcher reported, so a polling loop fires once per
    published version."""

    def __init__(self, models_root: str,
                 last_version: Optional[int] = None):
        self.models_root = os.path.abspath(models_root)
        self.last_version = last_version

    def latest(self) -> Optional[Tuple[int, str]]:
        for version, path in reversed(list_model_versions(self.models_root)):
            try:
                verify_model_dir(path)
            except CheckpointCorruptError:
                telemetry.counter_add("serving.model_rejected", 1)
                continue
            return version, path
        return None

    def poll(self) -> Optional[Tuple[int, str]]:
        newest = self.latest()
        if newest is None:
            return None
        if self.last_version is not None and \
                newest[0] <= self.last_version:
            return None
        self.last_version = newest[0]
        return newest
