"""A key-value store with the small part of the ``lmdb`` API the data path
uses, for hosts without the ``lmdb`` package.

Counterpart of ``c2matching_tpu/utils/lmdb_shim.py``, with the same
on-disk format, so that a database packed by either package reads in the
other: inside the ``*.lmdb`` directory, an append-only
``fallback_data.bin`` of the values and ``fallback_index.json`` mapping
each ascii key to its [offset, length]. ``open()`` gives an
``Environment`` (``begin``, ``close``, ``stat``); ``Transaction`` has
``get`` / ``put`` / ``commit`` / ``abort`` and, as a context manager,
commits on a clean exit and aborts on an exception (an aborted write
leaves the index as it was). A readonly open of a directory without an
index raises without creating anything.

The format is not lmdb's: real lmdb does not read these files, and this
store refuses a directory that holds a real ``data.mdb``. Where the
``lmdb`` package is installed, ``data/file_client.py`` and
``scripts/create_cufed_lmdb.py`` use it and nothing here runs; a database
packed here is then packed again from the source images.
"""
import io
import json
import os
import os.path as osp
import threading

_DATA = 'fallback_data.bin'
_INDEX = 'fallback_index.json'


class Error(Exception):
    """Mirror of lmdb.Error (base class for shim failures)."""


class Transaction:

    def __init__(self, env, write):
        self._env = env
        self._write = write
        # puts are buffered per transaction and merged into the shared
        # index only on commit — an aborted write transaction leaves the
        # environment untouched, matching real lmdb semantics (the data
        # bytes appended for aborted puts become unreferenced, like
        # lmdb's own abandoned pages)
        self._pending = {}
        if write and env._readonly:
            raise Error('cannot write to a readonly environment')

    # -- context manager: commit on clean exit, abort on exception (the
    # real lmdb.Transaction does the same)
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._write:
            if exc_type is None:
                self.commit()
            else:
                self.abort()
        return False

    def get(self, key, default=None):
        k = key.decode('ascii')
        entry = self._pending.get(k) or self._env._index.get(k)
        if entry is None:
            return default
        off, length = entry
        with self._env._lock:
            self._env._data.seek(off)
            return self._env._data.read(length)

    def put(self, key, value, **kwargs):
        if not self._write:
            raise Error('put() on a read-only transaction')
        with self._env._lock:
            self._env._data.seek(0, os.SEEK_END)
            off = self._env._data.tell()
            self._env._data.write(value)
        self._pending[key.decode('ascii')] = [off, len(value)]
        return True

    def commit(self):
        if self._write:
            self._env._index.update(self._pending)
            self._pending = {}
            self._env._flush_index()

    def abort(self):
        self._pending = {}


class Environment:

    def __init__(self, path, readonly):
        self._path = path
        self._readonly = readonly
        self._lock = threading.Lock()
        if osp.exists(osp.join(path, 'data.mdb')):
            raise Error(
                f'{path} is a real lmdb database; reading it requires the '
                f'lmdb package (this is the in-repo fallback store, which '
                f'uses its own format)')
        index_path = osp.join(path, _INDEX)
        data_path = osp.join(path, _DATA)
        if osp.exists(index_path):
            with io.open(index_path) as f:
                self._index = json.load(f)
        elif readonly:
            # before any filesystem side effect: real lmdb raises on a
            # missing readonly path without creating anything — a typo'd
            # dataroot must not leave a stray empty dir behind that a
            # later writeable open would silently initialize
            raise Error(f'no fallback store at {path} (missing {_INDEX})')
        else:
            self._index = {}
        os.makedirs(path, exist_ok=True)
        if readonly:
            self._data = io.open(data_path, 'rb')
        else:
            self._data = io.open(data_path, 'a+b')

    def begin(self, write=False, **kwargs):
        return Transaction(self, write)

    def stat(self):
        return {'entries': len(self._index)}

    def _flush_index(self):
        self._data.flush()
        tmp = osp.join(self._path, _INDEX + '.tmp')
        with io.open(tmp, 'w') as f:
            json.dump(self._index, f)
        os.replace(tmp, osp.join(self._path, _INDEX))

    def close(self):
        if not self._readonly:
            self._flush_index()
        self._data.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def open(path, readonly=False, lock=True, readahead=True, map_size=None,
         **kwargs):  # noqa: A001 - lmdb API name
    """lmdb.open-compatible constructor (extra kwargs accepted+ignored:
    the shim has no mmap/locking knobs to tune)."""
    return Environment(path, readonly=readonly)
