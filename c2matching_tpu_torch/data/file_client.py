"""Byte IO behind one ``get()``.

Counterpart of ``c2matching_tpu/data/file_client.py``, disk backend only.
The lmdb backend is queued with the lmdb tools; memcached and ceph have
no client here either. Any backend other than 'disk' raises.
"""


class HardDiskBackend:
    """Raw bytes from the local filesystem."""

    def get(self, filepath):
        with open(str(filepath), 'rb') as f:
            return f.read()


class FileClient:
    """Dispatches ``get`` to the configured backend."""

    _backends = {'disk': HardDiskBackend}

    def __init__(self, backend='disk', **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f'Backend {backend} is not supported by the port. Currently '
                f'supported ones are {list(self._backends)}')
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key='default'):
        del client_key  # the key names an lmdb database; disk has none
        return self.client.get(filepath)
