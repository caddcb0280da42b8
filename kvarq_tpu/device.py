'''
What the device can do: the one place that looks at JAX's platform.

The scan runs on a GPU, or on the CPU when JAX is pointed there
explicitly (``JAX_PLATFORMS=cpu``, as the test suite does).  Nothing
falls back from one to the other: when JAX cannot bring up the backend it
was asked for, its error propagates to the caller.
'''


class NoGPUError(RuntimeError):
    ''' a measurement path found no GPU '''


def platform():
    ''' JAX's default platform (``'gpu'`` or ``'cpu'``); initializes the
        backend on first call and raises if it cannot '''
    import jax
    return jax.default_backend()


def accelerated():
    ''' True when the scan runs on an accelerator, False on the CPU '''
    return platform() != 'cpu'


def compute_dtype():
    ''' dtype of one-hot matmul operands.  bf16 on the accelerator: one-hot
        values (0/1) and mode weights (0/1/2) are exact in bf16, and with
        f32 accumulation every match count (< 2^24) is exact, so results
        never rest on the card's default TF32 rounding of f32 operands.
        f32 on the CPU, whose XLA backend has no fast bf16 dot. '''
    import jax.numpy as jnp
    return jnp.bfloat16 if accelerated() else jnp.float32


def require_gpu():
    ''' :returns: ``jax.devices()`` when they are GPUs; raises
        :py:class:`NoGPUError` naming what JAX found otherwise '''
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        raise NoGPUError(
            'no GPU: JAX found %d %s device(s) (%s); this measurement '
            'runs on a GPU only' % (len(devices), devices[0].platform,
                                    devices[0].device_kind))
    return devices
