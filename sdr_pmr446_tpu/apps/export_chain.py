"""export_chain — AOT-export a chain step as a portable StableHLO artifact.

Production serving without Python tracing: the jitted block step
((state, iq[, params]) -> (state', outputs)) is lowered once, serialized
with jax.export, and can be reloaded (or embedded in a C++ serving stack
via the StableHLO/XLA runtime) with `jax.export.deserialize(blob).call`.
This is the analog of shipping the reference's compiled binary: the
signal graph is frozen, versioned, and runs with zero Python in the hot
path.

    python -m sdr_pmr446_tpu.apps.export_chain --config scanner \
        --out scanner_k10.jaxexport [--platforms cpu,cuda] [-k 10]

Round-trip equality vs the live chain is test-enforced
(tests/test_export.py).
"""

from __future__ import annotations

import argparse
import logging
import sys


def register_serializations() -> None:
    """Register the framework's NamedTuple pytrees with jax.export.

    Needed on BOTH sides: exporting, and any process that deserializes an
    artifact (importing this module is enough).  Names are stable wire
    identifiers — never change them once artifacts exist.
    """
    from jax import export
    from sdr_pmr446_tpu.runtime.state import ScannerState
    from sdr_pmr446_tpu.scanner.chain import RuntimeParams, StepOutputs
    from sdr_pmr446_tpu.scanner.dsd_in import DsdState, DsdOutputs
    from sdr_pmr446_tpu.scanner.single import SingleState
    for cls in (ScannerState, RuntimeParams, StepOutputs, DsdState,
                DsdOutputs, SingleState):
        try:
            export.register_namedtuple_serialization(
                cls, serialized_name=f"sdr_pmr446_tpu.{cls.__name__}")
        except ValueError:          # already registered in this process
            pass


register_serializations()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="export_chain",
        description="AOT-export a chain step (StableHLO via jax.export)")
    p.add_argument("--config", choices=["scanner", "dsd", "single"],
                   default="scanner")
    p.add_argument("-k", "--subchunks-per-step", type=int, default=10)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--platforms", type=str, default="",
                   help="comma-separated lowering targets (e.g. cpu,cuda); "
                        "default: the current backend")
    p.add_argument("--lowpass", action="store_true")
    p.add_argument("--fir-deemph", action="store_true")
    p.add_argument("-w", "--waterfall", type=int, default=0)
    p.add_argument("--input-format", default="cf32",
                   choices=["cf32", "cs16", "cu8", "cs8"],
                   help="scanner only: raw wire-word input decoded "
                        "on device")
    p.add_argument("--channel", type=int, default=5,
                   help="single config: fixed channel")
    return p


def build_exported(ns):
    """-> (jax.export.Exported, callable live step, example args)."""
    import jax
    from jax import export
    import jax.numpy as jnp
    from sdr_pmr446_tpu import config as C

    def struct_of(tree):
        return jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(jnp.shape(a),
                                           jnp.result_type(a)), tree)

    platforms = ([s.strip() for s in ns.platforms.split(",") if s.strip()]
                 or None)
    if ns.config == "scanner":
        from sdr_pmr446_tpu.scanner.chain import (ScannerChain,
                                                  make_runtime_params)
        chain = ScannerChain(
            C.BlockConfig(ns.subchunks_per_step), lowpass=ns.lowpass,
            fir_deemph=ns.fir_deemph, waterfall=ns.waterfall,
            input_format=ns.input_format)
        state0 = chain.init_state()
        params0 = make_runtime_params(C.ScannerArgs(
            lowpass=ns.lowpass, waterfall=ns.waterfall,
            fir_deemph=ns.fir_deemph))
        iq_struct = jax.ShapeDtypeStruct(
            (chain.step_arg_len,),
            jnp.complex64 if ns.input_format == "cf32" else jnp.float32)
        # fresh jit WITHOUT donation: donated buffers cannot be part of a
        # portable artifact's calling convention
        fn = jax.jit(chain._step_impl)
        exp = export.export(fn, platforms=platforms)(
            struct_of(state0), iq_struct, struct_of(params0))
        return exp, fn, (state0, iq_struct, params0)
    if ns.config == "dsd":
        from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain
        chain = DsdInChain(subchunks_per_step=ns.subchunks_per_step,
                           input_format=(ns.input_format
                                         if ns.input_format != "cu8"
                                         else "cf32"))
        state0 = chain.init_state()
        iq_struct = jax.ShapeDtypeStruct(
            (chain.step_arg_len,),
            jnp.complex64 if chain.input_format == "cf32" else jnp.float32)
        fn = jax.jit(chain._step_impl)
        exp = export.export(fn, platforms=platforms)(
            struct_of(state0), iq_struct)
        return exp, fn, (state0, iq_struct)
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain
    chain = SingleChannelChain(channel=ns.channel,
                               subchunks_per_step=ns.subchunks_per_step)
    state0 = chain.init_state()
    iq_struct = jax.ShapeDtypeStruct((chain.input_len,), jnp.complex64)
    fn = jax.jit(chain._step_impl)
    exp = export.export(fn, platforms=platforms)(
        struct_of(state0), iq_struct)
    return exp, fn, (state0, iq_struct)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    ns = build_parser().parse_args(argv)
    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    exp, _, _ = build_exported(ns)
    blob = exp.serialize()
    with open(ns.out, "wb") as f:
        f.write(blob)
    logging.info("exported %s step (K=%d) for platforms %s -> %s "
                 "(%d bytes)", ns.config, ns.subchunks_per_step,
                 list(exp.platforms), ns.out, len(blob))
    return 0


if __name__ == "__main__":
    sys.exit(main())
