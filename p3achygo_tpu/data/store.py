"""Artifact store bus: the run's shared model/chunk exchange.

Mirrors the reference's fs_utils.py/gcs_utils.py storage switch
(python/rl_loop/fs_utils.py:25-77, gcs_utils.py): selfplay workers and
the trainer never talk directly — they exchange artifacts (model
checkpoints, selfplay chunks, golden chunks) through a store with `.done`
markers gating visibility (cc/data/filename_format.h:14-15,
shuffler tf_record_watcher semantics).

Redesign notes: on a cluster the bus is typically GCS or a shared
NFS mount; both reduce to the same Store interface. `LocalStore` (a
rooted directory with atomic tmp+rename publishes) covers single-host
runs, tests, and NFS; `GcsStore` binds lazily to google-cloud-storage so
environments without the library (or credentials) fail with a clear
error only when a gs:// URL is actually requested.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional

MODELS_DIR = "models"  # gcs_utils MODELS_DIR
MODEL_CANDS_DIR = "model_cands"  # gcs_utils MODEL_CANDS_DIR
SP_CHUNKS_DIR = "sp_chunks"  # per-worker selfplay chunks
GOLDEN_CHUNKS_DIR = "golden_chunks"  # shuffler output
SGF_DIR = "sgf"
DONE_SUFFIX = ".done"

_MODEL_RE = re.compile(r"model_(\d+)$")


class LocalStore:
    """Store rooted at a local directory (or NFS mount).

    Publishes are atomic: payload lands under a tmp name and is renamed,
    and the `.done` marker is written strictly after the payload, so a
    reader that gates on `.done` never sees a torn artifact (the
    reference's chunk watcher protocol, tf_record_watcher).
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, name: str) -> str:
        return os.path.join(self.root, name)

    # -- bytes --
    def write_bytes(self, name: str, data: bytes):
        path = self._p(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def read_bytes(self, name: str) -> bytes:
        with open(self._p(name), "rb") as f:
            return f.read()

    # -- files / directories --
    def put(self, local_path: str, name: str, done: bool = False):
        """Publish a file OR directory at `name` (+ optional .done)."""
        dst = self._p(name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        elif os.path.exists(tmp):
            os.remove(tmp)
        if os.path.isdir(local_path):
            shutil.copytree(local_path, tmp)
        else:
            shutil.copy2(local_path, tmp)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        elif os.path.exists(dst):
            os.remove(dst)
        os.replace(tmp, dst)
        if done:
            self.mark_done(name)

    def get(self, name: str, local_path: str) -> str:
        src = self._p(name)
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        if os.path.isdir(src):
            if os.path.isdir(local_path):
                shutil.rmtree(local_path)
            shutil.copytree(src, local_path)
        else:
            shutil.copy2(src, local_path)
        return local_path

    def local_path(self, name: str) -> Optional[str]:
        """Direct filesystem path when the store IS a filesystem (lets
        consumers read in place instead of copying)."""
        return self._p(name)

    # -- listing / markers --
    def list(self, prefix: str) -> List[str]:
        base = self._p(prefix)
        if not os.path.isdir(base):
            return []
        return sorted(os.listdir(base))

    def exists(self, name: str) -> bool:
        return os.path.exists(self._p(name))

    def mark_done(self, name: str):
        self.write_bytes(name + DONE_SUFFIX, b"")

    def is_done(self, name: str) -> bool:
        return self.exists(name + DONE_SUFFIX)

    def delete(self, name: str):
        path = self._p(name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


class GcsStore:
    """GCS-backed store (gcs_utils.py parity). Requires
    google-cloud-storage; constructed lazily by make_store for gs://
    URLs. Method-for-method contract of LocalStore."""

    def __init__(self, url: str):
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as e:  # pragma: no cover - env without lib
            raise RuntimeError(
                "gs:// store requested but google-cloud-storage is not "
                "installed; use a local/NFS path or install the library"
            ) from e
        m = re.match(r"gs://([^/]+)/?(.*)", url)
        if not m:
            raise ValueError(f"bad gs:// url: {url}")
        self.bucket_name, self.prefix = m.group(1), m.group(2)
        self.client = storage.Client()
        self.bucket = self.client.bucket(self.bucket_name)

    def _key(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def write_bytes(self, name: str, data: bytes):
        self.bucket.blob(self._key(name)).upload_from_string(data)

    def read_bytes(self, name: str) -> bytes:
        return self.bucket.blob(self._key(name)).download_as_bytes()

    def put(self, local_path: str, name: str, done: bool = False):
        if os.path.isdir(local_path):
            for dirpath, _, files in os.walk(local_path):
                for fn in files:
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, local_path)
                    self.bucket.blob(
                        self._key(f"{name}/{rel}")).upload_from_filename(full)
        else:
            self.bucket.blob(self._key(name)).upload_from_filename(local_path)
        if done:
            self.mark_done(name)

    def get(self, name: str, local_path: str) -> str:
        blobs = list(self.client.list_blobs(self.bucket,
                                            prefix=self._key(name)))
        if len(blobs) == 1 and blobs[0].name == self._key(name):
            os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                        exist_ok=True)
            blobs[0].download_to_filename(local_path)
            return local_path
        for blob in blobs:
            rel = os.path.relpath(blob.name, self._key(name))
            dst = os.path.join(local_path, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            blob.download_to_filename(dst)
        return local_path

    def local_path(self, name: str) -> Optional[str]:
        return None

    def list(self, prefix: str) -> List[str]:
        key = self._key(prefix)
        names = set()
        for blob in self.client.list_blobs(self.bucket, prefix=key + "/"):
            rest = blob.name[len(key) + 1:]
            names.add(rest.split("/", 1)[0])
        return sorted(names)

    def exists(self, name: str) -> bool:
        if self.bucket.blob(self._key(name)).exists():
            return True
        it = self.client.list_blobs(self.bucket,
                                    prefix=self._key(name) + "/",
                                    max_results=1)
        return any(True for _ in it)

    def mark_done(self, name: str):
        self.write_bytes(name + DONE_SUFFIX, b"")

    def is_done(self, name: str) -> bool:
        return self.bucket.blob(self._key(name) + DONE_SUFFIX).exists()

    def delete(self, name: str):
        for blob in self.client.list_blobs(self.bucket,
                                           prefix=self._key(name)):
            blob.delete()


def make_store(url_or_path: str):
    """gs://bucket/prefix -> GcsStore; anything else -> LocalStore
    (configure_fs mode switch, fs_utils.py:25-34)."""
    if url_or_path.startswith("gs://"):
        return GcsStore(url_or_path)
    return LocalStore(url_or_path)


# ---------------- discovery helpers (fs_utils.py:37-65) ----------------
def model_name(gen: int) -> str:
    return f"{MODELS_DIR}/model_{gen:04d}"


def cand_name(gen: int) -> str:
    return f"{MODEL_CANDS_DIR}/model_{gen:04d}"


def most_recent_model(store, dirname: str = MODELS_DIR) -> int:
    """Largest published (done-marked) model generation, -1 if none."""
    best = -1
    for name in store.list(dirname):
        m = _MODEL_RE.search(name)
        if m and store.is_done(f"{dirname}/{name}"):
            best = max(best, int(m.group(1)))
    return best


def most_recent_model_cand(store) -> int:
    return most_recent_model(store, MODEL_CANDS_DIR)


def list_done_chunks(store, dirname: str = SP_CHUNKS_DIR) -> List[str]:
    """Chunk names (no .done suffix) that are fully published
    (.done-gated like the reference's tf_record_watcher)."""
    names = store.list(dirname)
    done = {n[: -len(DONE_SUFFIX)] for n in names if n.endswith(DONE_SUFFIX)}
    return sorted(n for n in names
                  if not n.endswith(DONE_SUFFIX) and not n.endswith(".tmp")
                  and n in done)
