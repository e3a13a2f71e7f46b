"""Object-store corpus transport for the serving pipeline.

Counterpart of aquaculture_tpu/data/store.py. The reference's detection
corpus lives in GCS end to end (blob listing: src/utils.py:192-238; per-label
download: src/process_yolo/geocode_results.py:34-66; uploads:
src/load_data/download_french_data.py:70-78). ``detect_files``,
``run_pipeline`` and ``run_pod_pipeline`` take ``store=`` and then treat
their paths as blob keys, streamed through a threaded fetch window into the
prefetching decode loader (data/loader.tile_batches_from_store) with no
local staging of the corpus.

Implementations: ``LocalBlobStore`` (a filesystem root), ``MemoryBlobStore``
(an in-process dict; the fake store of the tests) and ``GcsBlobStore``
(google-cloud-storage, imported when one is made).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Protocol, runtime_checkable


@runtime_checkable
class BlobStore(Protocol):
    """The pipeline's object-store surface. Keys are '/'-separated names."""

    def exists(self, key: str) -> bool: ...

    def put(self, key: str, data: bytes) -> None: ...

    def get(self, key: str) -> bytes: ...

    def list(self, prefix: str = "") -> List[str]: ...


class LocalBlobStore:
    """Filesystem-rooted store: keys are paths relative to ``root``."""

    def __init__(self, root: str):
        self.root = root

    def _p(self, key: str) -> str:
        return os.path.join(self.root, key)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._p(key))

    def put(self, key: str, data: bytes) -> None:
        full = self._p(key)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(data)

    def get(self, key: str) -> bytes:
        with open(self._p(key), "rb") as f:
            return f.read()

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            rel = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            for f in files:
                key = rel + f
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)


class MemoryBlobStore:
    """In-process dict store (thread-safe): the fake backend of the tests.
    ``get_count`` counts the fetches, so a test can see that a run
    streamed through the store."""

    def __init__(self, blobs: Dict[str, bytes] | None = None):
        self._blobs: Dict[str, bytes] = dict(blobs or {})
        self._lock = threading.Lock()
        self.get_count = 0

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._blobs[key] = bytes(data)

    def get(self, key: str) -> bytes:
        with self._lock:
            self.get_count += 1
            return self._blobs[key]

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._blobs if k.startswith(prefix))


class GcsBlobStore:  # pragma: no cover - needs google-cloud-storage and a bucket
    """GCS-backed store (the reference's transport: bucket blobs under a
    prefix). Needs ``google-cloud-storage``, imported when a store is made,
    so the package does not depend on it."""

    def __init__(self, bucket: str, client=None):
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as e:
            raise ImportError(
                "GcsBlobStore needs google-cloud-storage (reference "
                "requirements.txt); use LocalBlobStore/MemoryBlobStore "
                "in environments without it"
            ) from e
        self._bucket = (client or storage.Client()).get_bucket(bucket)

    def exists(self, key: str) -> bool:
        return self._bucket.blob(key).exists()

    def put(self, key: str, data: bytes) -> None:
        self._bucket.blob(key).upload_from_string(data)

    def get(self, key: str) -> bytes:
        return self._bucket.blob(key).download_as_bytes()

    def list(self, prefix: str = "") -> List[str]:
        return sorted(b.name for b in self._bucket.list_blobs(prefix=prefix))
