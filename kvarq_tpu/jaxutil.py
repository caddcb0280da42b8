'''
Process-wide JAX configuration: the persistent compilation cache.

Every CLI invocation is a fresh process, so without an on-disk cache each
one compiles the scan step anew.  The cache lives in
``$JAX_COMPILATION_CACHE_DIR`` when that is set, and nowhere else;
otherwise at one fixed path inside the checkout, ``<repo>/.jax_cache``
(listed in .gitignore).  A fixed path matters: XLA's per-fusion autotune
cache is derived from the cache directory, and that path is part of the
cache key, so a directory that moves never hits.
'''

import os

from kvarq_tpu.log import lo
from kvarq_tpu.util import get_root_path

DEFAULT_CACHE_DIR = get_root_path('.jax_cache')

_done = False


def cache_dir():
    ''' where the persistent compilation cache lives (see module
        docstring) '''
    return os.environ.get('JAX_COMPILATION_CACHE_DIR') or DEFAULT_CACHE_DIR


def ensure_compilation_cache():
    ''' enable JAX's on-disk executable cache in :py:func:`cache_dir`
        (idempotent).  Set ``KVARQ_JAX_CACHE=0`` to disable.  A cache
        directory that cannot be created is reported, and the scan runs
        without a persistent cache. '''
    global _done
    if _done:
        return
    _done = True
    if os.environ.get('KVARQ_JAX_CACHE', '1') == '0':
        return
    import jax
    path = cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        lo.warning('compilation cache disabled: cannot create %s (%s)'
                   % (path, e))
        return
    jax.config.update('jax_compilation_cache_dir', path)
    # cache everything that took noticeable compile time
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)
