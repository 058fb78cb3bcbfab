"""Every value-bearing dot and convolution in each chain's step pins
Precision.HIGHEST.

On an NVIDIA GPU a float32 matmul or convolution at default precision may
run in TF32 (about three decimal digits), which would move the chains off
their float64 oracles; HIGHEST keeps true fp32.  This audits the traced
step of every chain, through jit, scan, cond and shard_map.
"""

import jax
import jax.extend  # noqa: F401  (ClosedJaxpr, Jaxpr)
import jax.numpy as jnp
import pytest

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.scanner.chain import ScannerChain, make_runtime_params

HI = jax.lax.Precision.HIGHEST
K = 2


def _sub_jaxprs(v):
    if isinstance(v, jax.extend.core.ClosedJaxpr):
        yield v.jaxpr
    elif isinstance(v, jax.extend.core.Jaxpr):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _sub_jaxprs(x)


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            yield eqn
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from _dots(sub)


def _params():
    return make_runtime_params(C.ScannerArgs())


def _scanner(waterfall=0):
    ch = ScannerChain(C.BlockConfig(K), waterfall=waterfall,
                      input_format="cu8")
    return ch._step_impl, (ch.init_state(),
                           jnp.zeros((ch.step_arg_len,), jnp.float32),
                           _params())


def _faithful():
    from sdr_pmr446_tpu.scanner.faithful import FaithfulScannerChain
    ch = FaithfulScannerChain(subchunks_per_step=K)
    return ch.step, (ch.init_state(),
                     jnp.zeros((ch.input_len,), jnp.complex64), _params())


def _single():
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain
    ch = SingleChannelChain(channel=5, subchunks_per_step=K)
    return ch._step_impl, (ch.init_state(),
                           jnp.zeros((ch.input_len,), jnp.complex64))


def _dsd():
    from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain
    ch = DsdInChain(K)
    return ch._step_impl, (ch.init_state(),
                           jnp.zeros((ch.input_len,), jnp.complex64))


def _sharded():
    from sdr_pmr446_tpu.parallel.scanner_sharded import (ShardedScannerChain,
                                                         make_mesh)
    ch = ShardedScannerChain(make_mesh(1, 2), C.BlockConfig(K), waterfall=80)
    return ch._step, (ch.init_state(1),
                      jnp.zeros((1, ch.block.input_len), jnp.complex64),
                      _params())


@pytest.mark.parametrize("build", [
    _scanner, lambda: _scanner(waterfall=120), _faithful, _single, _dsd,
    _sharded], ids=["scanner", "scanner_waterfall", "faithful", "single",
                    "dsd_in", "sharded_scanner"])
def test_every_dot_and_conv_pins_highest(build):
    fn, args = build()
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    eqns = list(_dots(jaxpr))
    assert eqns, "no dot/conv found: the audit would pass vacuously"
    bad = []
    for e in eqns:
        p = e.params.get("precision")
        ps = p if isinstance(p, tuple) else (p,)
        if not all(x == HI for x in ps):
            bad.append((e.primitive.name, p, str(e.source_info.traceback)
                        if e.source_info.traceback else ""))
    assert not bad, bad
