# Copy of pointcloud_rl_tpu/utils/file_client.py for the PyTorch port, which imports nothing of that package.
"""Pluggable storage backends for reading training assets/datasets.

Parity target: reference ``pyrl/utils/file/file_client.py`` — a
``FileClient`` facade dispatching ``get``/``get_text`` to a registered
backend (disk, lmdb, memcached, ceph/petrel, http).  Backends whose client
libraries are not in this image (lmdb, memcached, ceph) import their
dependency lazily at construction, exactly like the reference, so the
registry and dispatch logic are fully functional and a backend lights up
the moment its library is installed.

File reads are host-side; the only design change is dropping the
torch-specific sys.path juggling of the reference's MemcachedBackend in
favor of plain imports.
"""

from __future__ import annotations

from abc import ABCMeta, abstractmethod
from typing import Optional
from urllib.request import urlopen


class BaseStorageBackend(metaclass=ABCMeta):
    @abstractmethod
    def get(self, filepath) -> bytes:
        ...

    @abstractmethod
    def get_text(self, filepath) -> str:
        ...


class HardDiskBackend(BaseStorageBackend):
    """Local filesystem (reference file_client.py:153)."""

    def get(self, filepath) -> bytes:
        with open(str(filepath), "rb") as f:
            return f.read()

    def get_text(self, filepath) -> str:
        with open(str(filepath)) as f:
            return f.read()


class HTTPBackend(BaseStorageBackend):
    """Fetch over HTTP(S) (reference HTTPBackend)."""

    def get(self, filepath) -> bytes:
        return urlopen(str(filepath)).read()

    def get_text(self, filepath) -> str:
        return urlopen(str(filepath)).read().decode("utf-8")


class LmdbBackend(BaseStorageBackend):
    """LMDB key-value store (reference file_client.py:114).  Requires the
    ``lmdb`` package (lazily imported, like the reference)."""

    def __init__(self, db_path, readonly: bool = True, lock: bool = False,
                 readahead: bool = False, **kwargs):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("LmdbBackend requires the 'lmdb' package") from e
        self.db_path = str(db_path)
        self._client = lmdb.open(self.db_path, readonly=readonly, lock=lock,
                                 readahead=readahead, **kwargs)

    def get(self, filepath) -> bytes:
        with self._client.begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))

    def get_text(self, filepath) -> str:
        return self.get(filepath).decode("utf-8")


class MemcachedBackend(BaseStorageBackend):
    """Memcached store (reference file_client.py:78).  Requires ``pymemcache``."""

    def __init__(self, server: str = "127.0.0.1:11211", **kwargs):
        try:
            from pymemcache.client.base import Client
        except ImportError as e:
            raise ImportError("MemcachedBackend requires the 'pymemcache' package") from e
        host, _, port = server.partition(":")
        self._client = Client((host, int(port or 11211)), **kwargs)

    def get(self, filepath) -> bytes:
        return self._client.get(str(filepath))

    def get_text(self, filepath) -> str:
        return self.get(filepath).decode("utf-8")


class CephBackend(BaseStorageBackend):
    """Ceph object store (reference file_client.py:15).  Requires ``ceph``;
    ``path_mapping`` rewrites path prefixes like the reference."""

    def __init__(self, path_mapping: Optional[dict] = None):
        try:
            import ceph
        except ImportError as e:
            raise ImportError("CephBackend requires the 'ceph' package") from e
        assert path_mapping is None or isinstance(path_mapping, dict)
        self._client = ceph.S3Client()
        self.path_mapping = path_mapping

    def get(self, filepath) -> bytes:
        filepath = str(filepath)
        if self.path_mapping is not None:
            for k, v in self.path_mapping.items():
                filepath = filepath.replace(k, v)
        return memoryview(self._client.Get(filepath)).tobytes()

    def get_text(self, filepath) -> str:
        return self.get(filepath).decode("utf-8")


class FileClient:
    """Facade dispatching to a named backend (reference file_client.py:169).

    ``FileClient.register_backend`` works as a classmethod or decorator."""

    _backends = {
        "disk": HardDiskBackend,
        "http": HTTPBackend,
        "lmdb": LmdbBackend,
        "memcached": MemcachedBackend,
        "ceph": CephBackend,
    }

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f"Backend {backend} is not supported. Currently supported ones"
                f" are {list(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    @classmethod
    def register_backend(cls, name, backend=None, force: bool = False):
        def _register(backend_cls):
            if not (isinstance(backend_cls, type) and issubclass(backend_cls, BaseStorageBackend)):
                raise TypeError(f"backend {backend_cls} must subclass BaseStorageBackend")
            if not force and name in cls._backends:
                raise KeyError(f"{name} is already registered; use force=True to override")
            cls._backends[name] = backend_cls
            return backend_cls

        if backend is not None:
            return _register(backend)
        return _register

    def get(self, filepath) -> bytes:
        return self.client.get(filepath)

    def get_text(self, filepath) -> str:
        return self.client.get_text(filepath)
