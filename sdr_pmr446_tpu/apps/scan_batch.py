"""scan_batch CLI — data-parallel scanning of MANY captures at once.

The production serving shape of the framework (the mesh's stream axis):
S independent IQ captures are scanned simultaneously on a
(stream, time) device mesh — the reference would need S processes with S
radios (src/sdr_pmr446.c runs exactly one).  The native BatchReader feeds
[S, block] sample planes with worker-thread format conversion; the sharded
chain demodulates every capture's active channel per step; per-capture
WAVs and event logs come out.

    python -m sdr_pmr446_tpu.apps.scan_batch cap1.cs16 cap2.cf32 ... \
        --out-dir scans/ [-s 18] [-p max] [--mesh S,T]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from sdr_pmr446_tpu import config as C

log = logging.getLogger("scan_batch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="scan_batch",
        description="scan many IQ captures in parallel on a device mesh")
    p.add_argument("captures", nargs="+", help="IQ capture files")
    p.add_argument("--format", type=str, default=None,
                   help="force input format (cf32/cs16/cu8); default: "
                        "per-file extension")
    p.add_argument("--out-dir", type=str, default=".",
                   help="directory for per-capture audio WAVs + event logs")
    p.add_argument("-s", "--squelch", type=float,
                   default=C.SDR_DEFAULT_SQUELCH_LEVEL)
    p.add_argument("-a", "--audio-gain", type=float,
                   default=C.SDR_DEFAULT_AUDIO_GAIN)
    p.add_argument("-m", "--mask", type=str, default="")
    p.add_argument("-p", "--lock-mode", choices=["start", "max"],
                   default="start")
    p.add_argument("-l", "--lowpass", action="store_true")
    p.add_argument("-w", "--waterfall", type=int, default=0,
                   help="per-capture ASCII waterfall of this width, written "
                        "to <stem>.waterfall.log")
    p.add_argument("--mesh", type=str, default="",
                   help="mesh shape S,T (default: all devices as streams)")
    p.add_argument("--coordinator", type=str, default="",
                   help="multi-host: coordinator host:port; run one "
                        "process per host with --num-processes/"
                        "--process-id (captures must be on a shared "
                        "filesystem; process 0 writes the outputs)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--subchunks-per-step", type=int, default=10)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="blocks fused into one device dispatch via lax.scan "
                        "(amortizes per-dispatch overhead; decisions "
                        "identical to 1, audio to f32 rounding)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint path: periodically persist (blocks "
                        "done, the full [S, ...] sharded state pytree, "
                        "host accumulators) so a killed batch job resumes "
                        "where it left off; a SIGTERM/SIGINT flushes a "
                        "final checkpoint before exit")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="dispatch groups between checkpoints "
                        "(with --checkpoint)")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"],
                   default="npz",
                   help="npz (default): dependency-free single file; "
                        "orbax: the JAX-ecosystem standard directory "
                        "format (needs the orbax-checkpoint package)")
    p.add_argument("--resume", action="store_true",
                   help="restore --checkpoint and continue mid-batch; "
                        "outputs are identical to an uninterrupted run")
    p.add_argument("--stop-after", type=int, default=0,
                   help="gracefully stop after N dispatch groups (the "
                        "same path a SIGTERM takes: final checkpoint "
                        "flush + partial outputs); 0 = run to EOF")
    p.add_argument("--device-decode", action="store_true",
                   help="all captures in ONE of cf32/cs16/cu8/cs8: ship "
                        "raw wire bytes to the mesh and decode per "
                        "time-shard on device (2-4x less host->device "
                        "traffic for the int formats; cf32 goes as its "
                        "byte-identical cf32w wire, zero host conversion)")
    return p


class _RawBatchReader:
    """[S, words] packed-f32 block reader over same-format raw captures."""

    def __init__(self, paths, fmt):
        from sdr_pmr446_tpu.ops import decode
        self.fmt = fmt
        self.dtype = decode.WIRE_DTYPE[fmt]
        self.fill = decode.WIRE_FILL[fmt]
        self.files = [open(p, "rb") for p in paths]

    def read_block(self, block_len):
        """block_len complex samples per stream; returns ([S, words], got)
        with short tails padded by the format's bias-center value."""
        from sdr_pmr446_tpu.ops import decode
        elems = 2 * block_len
        rows, got = [], 0
        for f in self.files:
            raw = np.fromfile(f, dtype=self.dtype, count=elems)
            got = max(got, len(raw) // 2)
            if len(raw) < elems:
                raw = np.concatenate(
                    [raw, np.full(elems - len(raw), self.fill, self.dtype)])
            rows.append(decode.pack_bytes(raw, self.fmt))
        return np.stack(rows), got

    def skip_blocks(self, n_blocks, block_len):
        """Seek past n_blocks already-processed blocks (checkpoint resume)."""
        off = n_blocks * 2 * block_len * np.dtype(self.dtype).itemsize
        for f in self.files:
            f.seek(off, 0)

    def close(self):
        for f in self.files:
            f.close()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(name)s] %(message)s",
                        stream=sys.stderr)
    ns = build_parser().parse_args(argv)
    if ns.checkpoint_backend == "orbax":
        try:
            import orbax.checkpoint  # noqa: F401
        except ImportError:
            logging.error("--checkpoint-backend orbax needs the "
                          "orbax-checkpoint package (not installed); use "
                          "the default npz backend")
            return 1
    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    try:
        mask = (C.parse_channel_mask(ns.mask) if ns.mask
                else (1 << C.MAX_CHANNELS) - 1)
    except ValueError as e:
        logging.error("%s", e)
        return 1
    if mask == 0:
        logging.error("No channels enabled in channel mask !")
        return 1

    import jax
    import jax.numpy as jnp
    from sdr_pmr446_tpu.io import native, wav
    from sdr_pmr446_tpu.parallel.scanner_sharded import (ShardedScannerChain,
                                                         make_mesh,
                                                         STREAM_AXIS,
                                                         TIME_AXIS)
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params
    from sdr_pmr446_tpu.runtime.transfer import fetch

    multihost = bool(ns.coordinator)
    if multihost:
        from sdr_pmr446_tpu.parallel import distributed as dist
        dist.initialize(ns.coordinator, ns.num_processes, ns.process_id)

    paths = ns.captures
    n_streams = len(paths)
    for pth in paths:
        if not os.path.exists(pth):
            logging.error("no such capture: %s", pth)
            return 1
    if ns.mesh:
        s_axis, t_axis = (int(v) for v in ns.mesh.split(","))
    else:
        s_axis = 1
        for cand in range(min(n_streams, len(jax.devices())), 0, -1):
            if n_streams % cand == 0:
                s_axis = cand
                break
        t_axis = 1
    if s_axis * t_axis > len(jax.devices()):
        logging.error("mesh %d,%d needs %d devices, host has %d",
                      s_axis, t_axis, s_axis * t_axis, len(jax.devices()))
        return 1
    if n_streams % s_axis != 0:
        logging.error("%d captures do not divide across %d stream shards",
                      n_streams, s_axis)
        return 1
    if ns.subchunks_per_step % t_axis != 0:
        logging.error("--subchunks-per-step %d does not divide across %d "
                      "time shards", ns.subchunks_per_step, t_axis)
        return 1
    os.makedirs(ns.out_dir, exist_ok=True)

    args = C.ScannerArgs(
        audio_gain=ns.audio_gain, squelch_level=ns.squelch,
        lowpass=ns.lowpass, channel_mask=mask, lock_mode=ns.lock_mode)
    fmts = [ns.format or os.path.splitext(pth)[1].lstrip(".") or "cf32"
            for pth in paths]
    # accept the same aliases the single-capture app does; unknown
    # extensions (".bin", ".dat", ...) default to cf32 like io/iq.py,
    # but an EXPLICIT unknown --format is an error, not silent cf32
    alias = {"sc16": "cs16", "rtlsdr": "cu8", "fc32": "cf32"}
    fmts = [alias.get(f, f) for f in fmts]
    known = ("cf32", "cs16", "cu8", "cs8")
    if ns.format and fmts[0] not in known:
        logging.error("unknown --format %r (supported: %s + aliases "
                      "sc16/rtlsdr/fc32)", ns.format, "/".join(known))
        return 1
    fmts = [f if f in known else "cf32" for f in fmts]
    packed_fmt = None
    if ns.device_decode:
        from sdr_pmr446_tpu.ops import decode
        fmts = ["cf32w" if f == "cf32" else f for f in fmts]
        if len(set(fmts)) != 1 or fmts[0] not in decode.PACKED_FORMATS:
            logging.error("--device-decode needs all captures in ONE of "
                          "%s (got: %s)",
                          "/".join(decode.PACKED_FORMATS),
                          ", ".join(sorted(set(fmts))))
            return 1
        packed_fmt = fmts[0]

    if ns.waterfall > 0:
        from sdr_pmr446_tpu.ops import spectrogram
        try:
            spectrogram.validate_width(ns.waterfall)
        except ValueError as e:
            logging.error("%s", e)
            return 1

    if multihost:
        mesh = dist.global_mesh(s_axis, t_axis,
                                axis_names=(STREAM_AXIS, TIME_AXIS))
    else:
        mesh = make_mesh(s_axis, t_axis)
    chain = ShardedScannerChain(
        mesh, C.BlockConfig(ns.subchunks_per_step), lowpass=ns.lowpass,
        input_format=packed_fmt or "cf32",
        waterfall=max(ns.waterfall, 0))
    params = make_runtime_params(args)
    if multihost:
        # globally-sharded initial state: every process materializes only
        # the stream shards its devices address
        from jax.sharding import PartitionSpec as P
        specs = jax.tree.map(lambda _: P(STREAM_AXIS),
                             chain._state_struct())
        host0 = jax.tree.map(
            lambda a: np.broadcast_to(
                np.asarray(a), (n_streams,) + np.asarray(a).shape).copy(),
            chain._state_struct())
        state = dist.globalize_pytree(mesh, specs, host0)
    else:
        state = chain.init_state(n_streams)
    block_len = chain.block.input_len
    log.info("scanning %d captures on a (%d stream x %d time) mesh",
             n_streams, s_axis, t_axis)

    if packed_fmt:
        reader = _RawBatchReader(paths, packed_fmt)
        feed_dtype = jnp.float32
    else:
        reader = native.BatchReader(paths, fmts)
        feed_dtype = jnp.complex64
    audio = [[] for _ in range(n_streams)]
    events = [[] for _ in range(n_streams)]
    wf_lines = [[] for _ in range(n_streams)] if ns.waterfall > 0 else None
    if wf_lines is not None:
        from sdr_pmr446_tpu.ui import waterfall as wf_ui
    subchunk = 0
    total_got = 0             # real samples read (longest capture)
    n_fuse = max(1, ns.steps_per_dispatch)

    # ---- checkpoint/resume: (blocks done, [S,...] state
    # pytree) via runtime/state.py backends + the host accumulators in a
    # sidecar npz, snapshotted only at drained-consistent boundaries so a
    # resumed run's outputs equal an uninterrupted run's
    from sdr_pmr446_tpu.runtime import state as state_mod

    def _save_accum(path):
        arrs = {"subchunk": np.int64(subchunk),
                "total_got": np.int64(total_got),
                # geometry guard: a resume must run the same block shape
                # or the block-count seek lands mid-block
                "subchunks_per_step": np.int64(ns.subchunks_per_step),
                "n_streams": np.int64(n_streams)}
        for s in range(n_streams):
            arrs[f"audio{s}"] = (np.stack(audio[s]) if audio[s]
                                 else np.zeros((0, 0), np.float32))
            arrs[f"events{s}"] = np.array("\n".join(events[s]))
            if wf_lines is not None:
                arrs[f"wf{s}"] = np.array("\n".join(wf_lines[s]))
        np.savez(path, **arrs)

    def _save_ckpt(blocks_done):
        if multihost:
            from jax.experimental import multihost_utils
            host_state = type(state)(*[
                np.asarray(multihost_utils.process_allgather(v, tiled=True))
                for v in state])
        else:
            host_state = state
        if ns.checkpoint_backend == "orbax":
            # orbax save is a COLLECTIVE under a multi-process runtime
            # (it syncs all processes internally): every process calls it
            # with the same replicated host tree; orbax elects the writer
            state_mod.save_state_orbax(ns.checkpoint, blocks_done,
                                       host_state)
            if not multihost or ns.process_id == 0:
                _save_accum(ns.checkpoint + ".accum.npz")
        else:
            if not multihost or ns.process_id == 0:
                state_mod.save_state(ns.checkpoint, blocks_done, host_state)
                _save_accum(ns.checkpoint + ".accum.npz")
            if multihost:
                from jax.experimental import multihost_utils
                multihost_utils.sync_global_devices("scan_batch_ckpt")
        log.info("checkpoint at block %d -> %s", blocks_done, ns.checkpoint)

    blocks_done = 0           # blocks fully processed AND drained
    if ns.resume:
        if not ns.checkpoint:
            logging.error("--resume needs --checkpoint")
            return 1
        load = (state_mod.load_state_orbax
                if ns.checkpoint_backend == "orbax"
                else state_mod.load_state)
        try:
            blocks_done, loaded = load(ns.checkpoint)
            acc = np.load(ns.checkpoint + ".accum.npz")
        except Exception as e:
            logging.error("cannot restore checkpoint '%s': %s",
                          ns.checkpoint, e)
            return 1
        # geometry guard: resuming under a different block shape or
        # capture count would seek mid-block / shape-mismatch the state
        ck_k = int(acc["subchunks_per_step"]) \
            if "subchunks_per_step" in acc else ns.subchunks_per_step
        ck_s = int(acc["n_streams"]) if "n_streams" in acc else n_streams
        if ck_k != ns.subchunks_per_step or ck_s != n_streams:
            logging.error(
                "checkpoint was written with --subchunks-per-step %d over "
                "%d captures; resume invoked with %d over %d — rerun with "
                "the checkpoint's geometry", ck_k, ck_s,
                ns.subchunks_per_step, n_streams)
            return 1
        ref = jax.tree.map(
            lambda a: np.broadcast_to(
                np.asarray(a), (n_streams,) + np.asarray(a).shape),
            chain._state_struct())
        try:
            loaded = state_mod.adapt_state_histories(loaded, ref)
        except ValueError as e:       # engine/config mismatch vs saved
            logging.error("cannot adapt checkpoint state: %s", e)
            return 1
        if multihost:
            from jax.sharding import PartitionSpec as P
            specs = jax.tree.map(lambda _: P(STREAM_AXIS),
                                 chain._state_struct())
            state = dist.globalize_pytree(
                mesh, specs, jax.tree.map(np.asarray, loaded))
        else:
            state = jax.tree.map(jnp.asarray, loaded)
        subchunk = int(acc["subchunk"])
        total_got = int(acc["total_got"])
        for s in range(n_streams):
            a = acc[f"audio{s}"]
            audio[s] = list(a) if a.size else []
            ev = str(acc[f"events{s}"])
            events[s] = ev.split("\n") if ev else []
            if wf_lines is not None and f"wf{s}" in acc:
                w = str(acc[f"wf{s}"])
                wf_lines[s] = w.split("\n") if w else []
        reader.skip_blocks(blocks_done, block_len)
        log.info("resumed at block %d (%d sub-chunks done)",
                 blocks_done, subchunk)

    # SIGTERM/SIGINT: finish the in-flight dispatch, flush a final
    # checkpoint, write partial outputs — the reference's whole-process
    # restart story (src/sdr_pmr446.c:933-940) with actual resume
    import signal
    stop_req = {"flag": False}

    def _stop(signum, frame):
        stop_req["flag"] = True
        log.info("signal %d: stopping after the current dispatch", signum)
    prev_handlers = []
    for _sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers.append((_sig, signal.signal(_sig, _stop)))
        except ValueError:        # non-main thread (tests)
            pass

    def _dispatch(group):
        nonlocal state
        if multihost:
            from jax.sharding import PartitionSpec as P
            if len(group) == 1:
                x = dist.make_global_array(
                    mesh, P(STREAM_AXIS, TIME_AXIS), group[0])
                state, out = chain.step(state, x, params)
            else:
                xs = dist.make_global_array(
                    mesh, P(None, STREAM_AXIS, TIME_AXIS), np.stack(group))
                state, out = chain.multi_step(state, xs, params)
        elif len(group) == 1:
            state, out = chain.step(state, group[0], params)
        else:
            state, out = chain.multi_step(state, jnp.stack(group), params)
        return out

    def _drain(out):
        nonlocal subchunk
        if multihost:
            # audio-rate outputs are tiny; gather them everywhere and let
            # process 0 do the writing
            from jax.experimental import multihost_utils
            host = {f: np.asarray(
                multihost_utils.process_allgather(v, tiled=True))
                for f, v in zip(out._fields, out)}
        else:
            host = dict(zip(out._fields, fetch(list(out))))
        for s in range(n_streams):
            for i in range(host["active_chan"].shape[1]):
                if host["audio_valid"][s][i]:
                    audio[s].append(host["audio"][s][i])
                if host["ev_tuned"][s][i]:
                    events[s].append(
                        f"subchunk {subchunk + i}: Tuned to channel "
                        f"{host['active_chan'][s][i] + 1} "
                        f"(RSSI: {host['rel_rssi'][s][i]:4.2f}dB)")
                if host["ev_detuned"][s][i]:
                    events[s].append(
                        f"subchunk {subchunk + i}: Detuned from channel "
                        f"{host['ev_new_chan'][s][i] + 1}")
                if host["ev_ct_acquired"][s][i]:
                    events[s].append(
                        f"subchunk {subchunk + i}: Acquired CTCSS code: "
                        f"{host['ct_max_idx'][s][i] + 1} (frequency: "
                        f"{host['ct_freq'][s][i]:3.2f}Hz)")
                if wf_lines is not None:
                    wf_lines[s].append(wf_ui.render_waterfall_line(
                        host["waterfall"][s][i],
                        float(host["rel_rssi"][s][i])))
        subchunk += host["active_chan"].shape[1]

    # software pipelining (same as runtime/driver.py): drain megastep i
    # only after dispatching i+1, so host-side fetch/render overlaps the
    # device compute of the next megastep
    group = []                # blocks awaiting one fused dispatch
    group_got = 0             # real samples in the undispatched group
    pending = None
    pending_blocks = 0
    groups_done = 0
    eof = False
    while not eof and not stop_req["flag"]:
        blk, got = reader.read_block(block_len)     # [S, block|words]
        if got == 0:
            eof = True
        else:
            total_got += got
            group_got += got
            eof = got < block_len
            # multihost: keep blocks as host numpy and globalize at
            # dispatch so each process ships only its addressable shards
            blk = np.asarray(blk)
            group.append(blk if multihost else jnp.asarray(blk, feed_dtype))
        if not group or (len(group) < n_fuse and not eof):
            continue
        out = _dispatch(group)
        nblk = len(group)
        group = []
        group_got = 0
        if pending is not None:
            _drain(pending)
            blocks_done += pending_blocks
        pending, pending_blocks = out, nblk
        groups_done += 1
        if ns.stop_after and groups_done >= ns.stop_after:
            stop_req["flag"] = True
        if (ns.checkpoint and ns.checkpoint_every > 0
                and groups_done % ns.checkpoint_every == 0):
            # checkpoint boundary: drain the in-flight megastep first so
            # the saved (state, accumulators) pair is consistent
            _drain(pending)
            blocks_done += pending_blocks
            pending = None
            _save_ckpt(blocks_done)
    if pending is not None:
        _drain(pending)
        blocks_done += pending_blocks
    reader.close()
    for _sig, _h in prev_handlers:    # main() is re-entrant in tests
        signal.signal(_sig, _h)
    if stop_req["flag"]:
        total_got -= group_got        # read but never dispatched
        if ns.checkpoint:
            _save_ckpt(blocks_done)
        log.info("stopped by signal at block %d; partial outputs follow",
                 blocks_done)

    if multihost and ns.process_id != 0:
        log.info("process %d done (process 0 writes the outputs)",
                 ns.process_id)
        return 0

    # unique output stems: same-named captures from different directories
    # must not overwrite each other's outputs
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    seen: set = set()
    for s, st in enumerate(stems):
        while st in seen:
            st = f"{st}.{s}"
        stems[s] = st
        seen.add(st)
    for s, pth in enumerate(paths):
        stem = stems[s]
        out_wav = os.path.join(ns.out_dir, f"{stem}.wav")
        a = (np.concatenate(audio[s]) if audio[s]
             else np.zeros(0, np.float32))
        wav.write_wav(out_wav, a, C.AUDIO_SAMPLERATE)
        out_log = os.path.join(ns.out_dir, f"{stem}.events.log")
        with open(out_log, "w") as f:
            f.write("\n".join(events[s]) + ("\n" if events[s] else ""))
        if wf_lines is not None:
            # drop rows of the zero-padded tail: only sub-chunks that
            # contain actually-read samples get a spectrum line (the
            # reference prints one row per received chunk)
            real_sub = -(-total_got // C.SUBCHUNK_IN)
            with open(os.path.join(ns.out_dir,
                                   f"{stem}.waterfall.log"), "w") as f:
                rows = wf_lines[s][:real_sub]
                f.write("\n".join(rows) + ("\n" if rows else ""))
        log.info("%s: %d audio samples (%.2f s), %d events -> %s",
                 stem, len(a), len(a) / C.AUDIO_SAMPLERATE, len(events[s]),
                 out_wav)
    log.info("Exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())
