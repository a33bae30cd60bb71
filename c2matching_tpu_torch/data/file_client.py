"""Byte IO behind one ``get()``.

Counterpart of ``c2matching_tpu/data/file_client.py``: the disk backend,
the lmdb backend (one environment a client key, values the encoded image
bytes under ascii keys) and the memcached and ceph backends, whose client
packages are not available and which raise ``ImportError`` as the JAX
package's do. Without the ``lmdb`` package the lmdb backend opens the
port's own store of the same API and format (``utils/lmdb_shim.py``) and
logs that it does.
"""
import logging
from abc import ABCMeta, abstractmethod


class BaseStorageBackend(metaclass=ABCMeta):
    """A byte store: ``get`` returns the bytes a path (and, for lmdb, a
    client key) names."""

    @abstractmethod
    def get(self, filepath):
        pass


class HardDiskBackend(BaseStorageBackend):
    """Raw bytes from the local filesystem."""

    def get(self, filepath):
        with open(str(filepath), 'rb') as f:
            return f.read()


class MemcachedBackend(BaseStorageBackend):

    def __init__(self, server_list_cfg, client_cfg, sys_path=None):
        raise ImportError(
            'memcached backend requires the mc package, which is not '
            'available in this environment.')

    def get(self, filepath):
        raise NotImplementedError


class CephBackend(BaseStorageBackend):

    def __init__(self, path_mapping=None):
        raise ImportError(
            'ceph backend requires the ceph package, which is not '
            'available in this environment.')

    def get(self, filepath):
        raise NotImplementedError


class LmdbBackend(BaseStorageBackend):
    """Values of lmdb databases, one environment per client key.

    Args:
        db_paths: a path or a list of paths of ``*.lmdb`` directories.
        client_keys: a key or a list of keys, one per path.
        readonly, lock, readahead: passed to ``lmdb.open``.
    """

    def __init__(self, db_paths, client_keys='default', readonly=True,
                 lock=False, readahead=False, **kwargs):
        try:
            import lmdb
        except ImportError:
            from ..utils import lmdb_shim as lmdb
            logging.getLogger('base').info(
                'lmdb package not available; using the port\'s key-value '
                'store of the same format (c2matching_tpu_torch/utils/'
                'lmdb_shim.py)')
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError(f'{len(client_keys)} client keys for '
                             f'{len(db_paths)} lmdb paths')
        self._client = {
            client_key: lmdb.open(path, readonly=readonly, lock=lock,
                                  readahead=readahead, **kwargs)
            for client_key, path in zip(client_keys, db_paths)
        }

    def get(self, filepath, client_key):
        """The value under the ascii key ``filepath`` of ``client_key``'s
        database (None when absent)."""
        with self._client[client_key].begin(write=False) as txn:
            return txn.get(str(filepath).encode('ascii'))


class FileClient:
    """Dispatches ``get`` to the configured backend."""

    _backends = {
        'disk': HardDiskBackend,
        'memcached': MemcachedBackend,
        'ceph': CephBackend,
        'lmdb': LmdbBackend,
    }

    def __init__(self, backend='disk', **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f'Backend {backend} is not supported. Currently supported '
                f'ones are {list(self._backends)}')
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key='default'):
        """The bytes of ``filepath``; ``client_key`` names the lmdb
        database (disk has none)."""
        if self.backend == 'lmdb':
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)
