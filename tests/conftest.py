import os

# Tests run on the CPU, on a virtual 8-device mesh so multi-device sharding
# logic is exercised without a GPU.  KVARQ_TEST_GPU=1 leaves the platform
# alone, for the tests marked ``gpu`` (run: KVARQ_TEST_GPU=1 pytest -m gpu).
xla_flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in xla_flags:
    os.environ['XLA_FLAGS'] = (
        xla_flags + ' --xla_force_host_platform_device_count=8').strip()

# the small-input numpy fast path would hide the tensor-scan code from
# every fixture-sized countseqs test; disable it suite-wide (the path has
# its own dedicated parity test that re-enables it)
os.environ.setdefault('KVARQ_SMALL_SCAN', '0')

if os.environ.get('KVARQ_TEST_GPU') != '1':
    # chosen explicitly, before any JAX backend initializes
    os.environ['JAX_PLATFORMS'] = 'cpu'

import pytest  # noqa: E402

HERE = os.path.abspath(os.path.dirname(__file__))


@pytest.fixture
def fastqs_dir():
    return os.path.join(HERE, 'fastqs')


@pytest.fixture(autouse=True)
def reset_engine_config():
    ''' every test starts from the engine's built-in defaults '''
    from kvarq_tpu import engine
    engine.config(maxerrors=0, minoverlap=20, minreadlength=10,
                  nthreads=1, Amin='!', Azero='!',
                  mesh=os.environ.get('KVARQ_MESH', ''),
                  backend=os.environ.get('KVARQ_BACKEND', 'auto'),
                  sieve=os.environ.get('KVARQ_SIEVE', 'auto'),
                  batchsize=int(os.environ.get('KVARQ_BATCHSIZE', '16384')))
    yield


@pytest.fixture(autouse=True)
def gpu_gate(request):
    ''' tests marked ``gpu`` skip unless KVARQ_TEST_GPU=1, and then fail
        (never fall back to the CPU) when JAX finds no GPU.  Decided here,
        per test, never at import: every xdist worker collects the same
        tests. '''
    if request.node.get_closest_marker('gpu') is None:
        return
    if os.environ.get('KVARQ_TEST_GPU') != '1':
        pytest.skip('needs a GPU: run KVARQ_TEST_GPU=1 pytest -m gpu on a '
                    'machine with one')
    from kvarq_tpu.device import require_gpu
    require_gpu()
