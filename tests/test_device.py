'''
The device-capability helper (kvarq_tpu.device), the compile-cache
placement (kvarq_tpu.jaxutil), the native reader's atomic build, and
chip_smoke.py's refusal to run without a GPU.
'''

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from kvarq_tpu import device

HERE = os.path.abspath(os.path.dirname(__file__))
ROOT = os.path.dirname(HERE)


def test_cpu_capabilities():
    import jax.numpy as jnp
    assert device.platform() == 'cpu'
    assert not device.accelerated()
    assert device.compute_dtype() == jnp.float32


def test_require_gpu_refuses_cpu():
    with pytest.raises(device.NoGPUError, match='no GPU'):
        device.require_gpu()


def test_backend_failure_is_not_hidden(monkeypatch):
    ''' a backend that cannot start raises through every consumer of the
        helper -- nothing falls back to the CPU or the numpy matcher '''
    import jax
    from kvarq_tpu.engine.match_xla import XlaMatcher
    from kvarq_tpu.engine.tensor_scan import resolve_backend

    def broken():
        raise RuntimeError('Unable to initialize backend cuda')
    monkeypatch.setattr(jax, 'default_backend', broken)
    monkeypatch.delenv('KVARQ_TENSOR_BACKEND', raising=False)
    for call in (device.accelerated, device.compute_dtype, resolve_backend,
                 lambda: XlaMatcher(['ACGT' * 8], 1, 10)):
        with pytest.raises(RuntimeError, match='Unable to initialize'):
            call()


@pytest.mark.parametrize('env_dir', [None, 'custom'])
def test_compilation_cache_placement(monkeypatch, tmp_path, env_dir):
    ''' $JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache '''
    import jax
    from kvarq_tpu import jaxutil
    if env_dir is None:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        want = os.path.join(ROOT, '.jax_cache')
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', want)
    monkeypatch.delenv('KVARQ_JAX_CACHE', raising=False)
    assert jaxutil.cache_dir() == want

    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(jaxutil, '_done', False)
    try:
        jaxutil.ensure_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update('jax_compilation_cache_dir', saved)


def test_compilation_cache_unwritable_is_reported(monkeypatch, tmp_path):
    ''' a cache directory that cannot be created is logged, not hidden,
        and leaves JAX's cache setting alone '''
    import jax
    from kvarq_tpu import jaxutil
    blocker = tmp_path / 'file'
    blocker.write_text('')
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(blocker / 'cache'))
    monkeypatch.delenv('KVARQ_JAX_CACHE', raising=False)
    monkeypatch.setattr(jaxutil, '_done', False)
    warnings = []
    monkeypatch.setattr(jaxutil.lo, 'warning', warnings.append)
    saved = jax.config.jax_compilation_cache_dir
    jaxutil.ensure_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == saved
    assert len(warnings) == 1 and 'cannot create' in warnings[0]


def test_native_build_is_atomic(monkeypatch, tmp_path):
    ''' the library appears under its final name only complete, and no
        temporary file is left behind -- on success or failure '''
    from kvarq_tpu.engine import native
    lib = str(tmp_path / '_reader.so')
    seen = []

    def fake_compile(path, generic):
        seen.append(path)
        assert not os.path.exists(lib)
        with open(path, 'w') as fd:
            fd.write('built')
    monkeypatch.setattr(native, '_compile', fake_compile)
    native._build(lib)
    assert seen[0] != lib
    assert open(lib).read() == 'built'
    assert os.listdir(tmp_path) == ['_reader.so']

    def failing_compile(path, generic):
        with open(path, 'w') as fd:
            fd.write('half')
        raise OSError('compiler died')
    monkeypatch.setattr(native, '_compile', failing_compile)
    with pytest.raises(OSError):
        native._build(lib)
    assert open(lib).read() == 'built'
    assert os.listdir(tmp_path) == ['_reader.so']


def test_multihost_initialize_single_process(monkeypatch):
    ''' with no coordinator configured nothing calls
        jax.distributed.initialize (no cluster auto-detection) '''
    import jax
    from kvarq_tpu.parallel import multihost
    for var in ('KVARQ_COORDINATOR', 'KVARQ_NUM_PROCESSES',
                'KVARQ_PROCESS_ID'):
        monkeypatch.delenv(var, raising=False)

    def forbidden(**kwargs):
        raise AssertionError('jax.distributed.initialize called')
    monkeypatch.setattr(jax.distributed, 'initialize', forbidden)
    assert multihost.initialize() == (0, 1)


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    ''' without a GPU chip_smoke.py exits non-zero, names the missing
        GPU and prints no result line '''
    proc = _run_smoke(ROOT, os.path.join(ROOT, 'chip_smoke.py'))
    assert proc.returncode != 0
    assert 'no GPU' in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    ''' chip_smoke.py in a directory without the rest of the repo exits
        non-zero and prints no result line '''
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
    proc = _run_smoke(str(tmp_path), 'chip_smoke.py')
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_comparison_catches_differences():
    ''' the bitwise comparison chip_smoke.py gates every phase with '''
    sys.path.insert(0, ROOT)
    import chip_smoke
    bcs = [np.arange(10).reshape(5, 2)]
    stats = {'nseqhits': (1,), 'records_parsed': 3}
    chip_smoke.equal_results((bcs, stats), ([b.copy() for b in bcs],
                                            dict(stats)), 'same')
    other = [bcs[0] + (np.arange(10).reshape(5, 2) == 7)]
    with pytest.raises(AssertionError, match='basecounts of template 0'):
        chip_smoke.equal_results((bcs, stats), (other, stats), 'bc')
    with pytest.raises(AssertionError, match='records_parsed'):
        chip_smoke.equal_results((bcs, stats),
                                 (bcs, dict(stats, records_parsed=4)), 'st')
