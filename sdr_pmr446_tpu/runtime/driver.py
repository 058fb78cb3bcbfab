"""Host-side streaming driver: blocks in, audio/events out.

Plays the role of the reference's main loop plumbing (ring buffers, logging,
signal handling; src/sdr_pmr446.c:788-931) around the jitted block step:
feeds fixed-size IQ blocks, drains per-sub-chunk outputs, renders reference-
format log lines for tune/detune/change/CTCSS events (src/sdr_pmr446.c:
838-862,614-626), and accumulates the active-channel audio stream.

Block-streaming resume: the driver can checkpoint (block_index, state) and
continue — the failure-recovery design of SURVEY.md §5.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterable, List, Optional

import numpy as np
import jax.numpy as jnp

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.scanner.chain import (ScannerChain, StepOutputs,
                                          make_runtime_params)

log = logging.getLogger("sdr_pmr446")


def _device_prefetch(blocks: Iterable[np.ndarray], dtype, depth: int):
    """Stage input blocks on device ``depth`` ahead of consumption.

    jax.device_put enqueues the host->device copy asynchronously, so while
    the chain computes block i the transfer of block i+1 (and i+2, ...) is
    already in flight — the H2D analog of the reference decoupling its
    blocking SDR read from the audio thread via ring buffers
    (src/sdr_pmr446.c:789,903-906).  Values are unchanged: this yields the
    same arrays, just device-resident earlier.
    """
    import collections
    import jax
    q = collections.deque()
    for blk in blocks:
        q.append(jax.device_put(jnp.asarray(blk, dtype)))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


@dataclasses.dataclass
class ScanResult:
    audio: np.ndarray            # concatenated active-channel audio @12.5 kHz
    audio_subchunks: np.ndarray  # sub-chunk index of each audio block
    active_trace: np.ndarray     # [n_subchunks] active channel per sub-chunk
    rssi_trace: np.ndarray       # [n_subchunks, 16]
    rel_rssi: np.ndarray         # [n_subchunks]
    events: List[str]            # formatted log lines
    waterfall: Optional[np.ndarray]  # [n_subchunks, W] dB rows or None


class ScannerDriver:
    def __init__(self, args: Optional[C.ScannerArgs] = None,
                 subchunks_per_step: int = 10,
                 on_subchunk: Optional[Callable] = None,
                 metrics_path: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 input_format: str = "cf32",
                 steps_per_dispatch: int = 1,
                 prefetch_depth: int = 2,
                 checkpoint_backend: str = "npz"):
        self.args = args or C.ScannerArgs()
        # input_format "cs16"/"cu8": run() consumes blocks of RAW wire
        # bytes packed as f32 words (ops/decode.py) and the chain decodes
        # on device — 2-4x less host->device traffic than cf32; "cf32w"
        # ships a cf32 capture's own bytes (zero host conversion)
        self.chain = ScannerChain(
            C.BlockConfig(subchunks_per_step),
            lowpass=self.args.lowpass, fir_deemph=self.args.fir_deemph,
            waterfall=self.args.waterfall, input_format=input_format)
        self.params = make_runtime_params(self.args)
        self.state = self.chain.init_state()
        self.block_index = 0
        self.subchunk = 0
        self.on_subchunk = on_subchunk
        self.metrics_path = metrics_path
        # failure recovery (SURVEY §5): periodically persist
        # (block_index, state pytree); restore() resumes mid-capture
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        # "npz" (single-file) or "orbax" (directory; the JAX-ecosystem
        # standard — sharded-array-aware for multi-host deployments)
        assert checkpoint_backend in ("npz", "orbax")
        self.checkpoint_backend = checkpoint_backend
        self._resume_skip = 0            # armed by restore(), one-shot
        # dispatch S blocks per jitted call (chain.multi_step lax.scan):
        # amortizes the per-dispatch runtime floor S-fold in streaming
        # deployments; decisions/events equal S single steps exactly,
        # audio to f32 rounding (test-enforced).  Checkpoints land on
        # megastep boundaries.
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        # device-stage this many input blocks ahead (H2D overlaps compute);
        # 0/1 disables the read-ahead
        self.prefetch_depth = max(1, int(prefetch_depth))
        # cooperative stop (the reference's exit_via_sig flag,
        # src/sdr_pmr446.c:190-199): request_stop() makes run() finish the
        # current block, flush a final checkpoint, and return the partial
        # result instead of tearing the process down mid-state
        self._stop_requested = False
        self.stopped = False

    def request_stop(self) -> None:
        """Ask run() to stop at the next block boundary (signal-safe: just
        sets a flag, like the reference's sighandler)."""
        self._stop_requested = True

    def checkpoint_now(self) -> None:
        """Persist (block_index, state) immediately, ignoring the cadence —
        the final flush on a signal-triggered exit."""
        if not self.checkpoint_path:
            return
        from sdr_pmr446_tpu.runtime import state as state_io
        save = (state_io.save_state_orbax
                if self.checkpoint_backend == "orbax"
                else state_io.save_state)
        save(self.checkpoint_path, self.block_index, self.state)

    def restore(self, path: Optional[str] = None) -> int:
        """Load a checkpoint; run() then skips the already-processed blocks
        of its input iterator.  Returns the restored block index."""
        from sdr_pmr446_tpu.runtime import state as state_io
        load = (state_io.load_state_orbax
                if self.checkpoint_backend == "orbax"
                else state_io.load_state)
        self.block_index, loaded = load(path or self.checkpoint_path)
        # configuration changes move history lengths (e.g. the longer
        # de-emphasis history under fir_deemph): reconcile against this
        # chain's state shapes instead of failing on restore
        self.state = state_io.adapt_state_histories(loaded,
                                                    self.chain.init_state())
        self.subchunk = self.block_index * self.chain.block.subchunks_per_step
        self._resume_skip = self.block_index
        log.info("restored checkpoint at block %d (%d sub-chunks)",
                 self.block_index, self.subchunk)
        return self.block_index

    def _maybe_checkpoint(self) -> None:
        if (self.checkpoint_path and self.checkpoint_every
                and self.block_index % self.checkpoint_every == 0):
            from sdr_pmr446_tpu.runtime import state as state_io
            save = (state_io.save_state_orbax
                    if self.checkpoint_backend == "orbax"
                    else state_io.save_state)
            save(self.checkpoint_path, self.block_index, self.state)

    @property
    def block_len(self) -> int:
        """Complex samples per block (time accounting)."""
        return self.chain.block.input_len

    @property
    def feed_len(self) -> int:
        """Array length run() expects per block: complex samples for cf32,
        packed f32 transport words for cs16/cu8."""
        return self.chain.step_arg_len

    def run(self, blocks: Iterable[np.ndarray]) -> ScanResult:
        audio, audio_sub = [], []
        active, rssi, rel, events = [], [], [], []
        wf_rows = [] if self.args.waterfall > 0 else None
        # software pipelining: dispatch block i+1 before draining block i's
        # outputs, so host-side fetch/render overlaps device compute (the
        # role the reference's audio ring plays across its two threads,
        # src/sdr_pmr446.c:903-906)
        pending = None
        # one-shot: only the run() immediately after restore() skips the
        # already-processed prefix of its iterator; later run() calls on the
        # same driver must consume their iterators from the start
        skip = self._resume_skip
        self._resume_skip = 0
        feed_dtype = (jnp.complex64 if self.chain.input_format == "cf32"
                      else jnp.float32)
        S = self.steps_per_dispatch

        def _after_skip(it):
            for i, b in enumerate(it):
                if i >= skip:
                    yield b

        staged = _device_prefetch(_after_skip(blocks), feed_dtype,
                                  self.prefetch_depth)
        group: List[jnp.ndarray] = []      # blocks awaiting one megastep
        self.stopped = False
        try:
            for blk in staged:
                if S > 1:
                    group.append(blk)
                    if len(group) < S:
                        continue
                    self.state, out = self.chain.multi_step(
                        self.state, jnp.stack(group), self.params)
                    group = []
                else:
                    self.state, out = self.chain.step(
                        self.state, blk, self.params)
                if pending is not None:
                    self._drain(pending, audio, audio_sub, active, rssi, rel,
                                events, wf_rows)
                pending = out
                self.block_index += 1 if S == 1 else S
                self._maybe_checkpoint()
                if self._stop_requested:
                    break
            # tail blocks that didn't fill a megastep run as single steps
            # (skipped on a stop request — they resume from the checkpoint)
            for blk in (() if self._stop_requested else group):
                self.state, out = self.chain.step(self.state, blk,
                                                  self.params)
                if pending is not None:
                    self._drain(pending, audio, audio_sub, active, rssi, rel,
                                events, wf_rows)
                pending = out
                self.block_index += 1
                self._maybe_checkpoint()
            if pending is not None:
                self._drain(pending, audio, audio_sub, active, rssi, rel,
                            events, wf_rows)
        except KeyboardInterrupt:
            # backstop for an un-trapped SIGINT landing mid-step/mid-drain:
            # keep everything drained so far; the pending block's outputs
            # are dropped (a potential partial drain must not run twice) —
            # state and checkpoints stay consistent, resume replays it
            self._stop_requested = True
        if self._stop_requested:
            self.stopped = True
            self._stop_requested = False
            # final flush: a SIGTERM'd long run must lose nothing since
            # the last cadence checkpoint (reference teardown analog,
            # src/sdr_pmr446.c:933-940)
            self.checkpoint_now()
        return ScanResult(
            audio=(np.concatenate(audio) if audio
                   else np.zeros(0, np.float32)),
            audio_subchunks=np.asarray(audio_sub, np.int64),
            active_trace=np.concatenate(active) if active else np.zeros(0, int),
            rssi_trace=(np.concatenate(rssi) if rssi
                        else np.zeros((0, C.NUM_CHANNELS))),
            rel_rssi=np.concatenate(rel) if rel else np.zeros(0),
            events=events,
            waterfall=(np.concatenate(wf_rows) if wf_rows else None),
        )

    # ------------------------------------------------------------------
    def _drain(self, out: StepOutputs, audio, audio_sub, active, rssi, rel,
               events, wf_rows) -> None:
        from sdr_pmr446_tpu.runtime.transfer import fetch
        o = dict(zip(out._fields, fetch(list(out))))
        k = len(o["active_chan"])
        for i in range(k):
            sub = self.subchunk + i
            msgs = self._event_lines(o, i)
            for m in msgs:
                events.append(m)
                if self.args.waterfall == 0:
                    log.info(m)
            if o["audio_valid"][i]:
                audio.append(o["audio"][i])
                audio_sub.append(sub)
            if self.metrics_path is not None:
                from sdr_pmr446_tpu.utils.profiling import log_jsonl
                log_jsonl(self.metrics_path, {
                    "subchunk": sub,
                    "active_chan": int(o["active_chan"][i]),
                    "rel_rssi": float(o["rel_rssi"][i]),
                    "rssi_db": [round(float(v), 2)
                                for v in o["rssi_db"][i]],
                    "ctcss_detected": bool(o["ct_detected"][i]),
                    "ctcss_code": int(o["ct_max_idx"][i]) + 1,
                    "events": msgs,
                })
            if self.on_subchunk is not None:
                self.on_subchunk(sub, {f: o[f][i] for f in o})
        active.append(o["active_chan"])
        rssi.append(o["rssi_db"])
        rel.append(o["rel_rssi"])
        if wf_rows is not None:
            wf_rows.append(o["waterfall"])
        self.subchunk += k

    def _event_lines(self, o, i) -> List[str]:
        """Reference-format log lines (src/sdr_pmr446.c:838-862,614-626)."""
        msgs = []
        if o["ev_changed"][i]:
            msgs.append(f"Changed active channel from "
                        f"{o['ev_prev_chan'][i] + 1} to "
                        f"{o['ev_new_chan'][i] + 1}")
        if o["ev_tuned"][i]:
            msgs.append(f"Tuned to channel {o['active_chan'][i] + 1} "
                        f"(RSSI: {o['rel_rssi'][i]:4.2f}dB)")
        if o["ev_detuned"][i]:
            msgs.append(f"Detuned from channel {o['ev_new_chan'][i] + 1}")
        if o["ev_ct_acquired"][i]:
            msgs.append(f"Acquired CTCSS code: {o['ct_max_idx'][i] + 1} "
                        f"(frequency: {o['ct_freq'][i]:3.2f}Hz)")
        if o["ev_ct_changed"][i]:
            msgs.append(f"CTCSS code change: {o['ct_max_idx'][i] + 1} "
                        f"(frequency: {o['ct_freq'][i]:3.2f}Hz)")
        if o["ev_ct_lost"][i]:
            msgs.append("Lost CTCSS code")
        return msgs
