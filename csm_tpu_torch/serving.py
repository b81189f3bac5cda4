"""Serving: frame-by-frame generation with streamed audio, and continuous
batching (counterpart of ``csm_tpu/serving.py``).

:class:`CSMStreamer` runs a batch of streams frame by frame (prefill once,
then one frame step per call) and can feed each frame to a streaming Mimi
decoder, so callers receive 80 ms PCM chunks as frames exist.
:class:`CSMServer` serves requests: ``n_slots`` streams decode in lockstep
as one ``[n_slots, 1, 33]`` step over a shared KV cache with a per-slot
index, and requests are admitted into free slots mid-flight.

Randomness is per request: each request draws its noise from its own
``torch.Generator`` (``submit(generator=...)`` or a seed), one ``[32,
Va]`` table per frame, so its tokens do not depend on the rest of the batch
and equal a solo ``generate(..., generator=[g])`` from the same seed.
``jax.random`` keys cannot be reproduced in PyTorch, so seeds are not the
JAX package's.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.generation import _next_frame_inputs, _pad_to_bucket, generate_frame
from csm_tpu_torch.models import csm
from csm_tpu_torch.utils.profiling import span


def _window(config: CSMConfig, frames: int) -> int:
    """A cache window of ``min(frames, max_seq_len)`` slots rounded up to a
    multiple of 128, as generation sizes its own."""
    return ((min(frames, config.max_seq_len) + 127) // 128) * 128


def _prefill_prefix(params, config, ids, mask, cache, S: int, first: bool):
    """The backbone over a prefix's (bucket-padded) frames into ``cache``,
    its index pinned after the ``S`` real frames.  No frame is sampled: a
    prefix only seeds caches (K/V rows, and a hybrid backbone's recurrent
    states after the real frames).  ``first``: the prefix starts the cache
    (the flash prefill); a stacked prefix continues its parent's
    (masked-bias path: the flash kernel's queries start at position 0)."""
    with span("csm.serve.register", S=S, state_bytes=cache.state_bytes):
        out = csm.forward(params, config, ids, mask, cache=cache, last_index=S - 1,
                          flash_prefill=first)
    return dataclasses.replace(out.cache, index=cache.index + S)


class CSMStreamer:
    """Stateful frame-by-frame generator over a batch of streams.

    ``qdec`` / ``qbb`` / ``qsb`` / ``specdec`` select the tiers as in
    :func:`csm_tpu_torch.generation.generate_compiled` (the prompt's prefill
    stays in the param dtype).  With one ``generator`` the frames equal
    ``generate_compiled``'s with ``stop_mode="stream"``."""

    def __init__(self, params: dict, config: CSMConfig, codec=None, temperature: float = 1.0,
                 topk: int = 50, greedy: bool = False, stop_on_all_zeros: bool = True,
                 qdec: Optional[dict] = None, qbb: Optional[dict] = None,
                 qsb: Optional[dict] = None, specdec: bool = False):
        self.params = params
        self.config = config
        self.codec = codec
        self.device = params["projection"].device
        self.stop_on_all_zeros = stop_on_all_zeros
        self._kw = dict(temperature=temperature, topk=topk, greedy=greedy, qdec=qdec,
                        specdec=specdec)
        self._qbb, self._qsb = qbb, qsb
        self.cache = None
        self._gen = None
        self._decoder = None
        self._done = None
        self._last_frame = None
        self._prefixes: dict = {}  # prefix_id -> (seeded cache, n_frames)
        self._prefix_seq = 0  # monotonic: ids are never reused after drop_prefix

    def _tensors(self, ids, mask):
        return (torch.as_tensor(ids, device=self.device).long(),
                torch.as_tensor(mask, device=self.device).float())

    @torch.no_grad()
    def register_prefix(self, input_ids, attention_mask, max_new_frames: int = 1024) -> str:
        """Prefill a shared context once (a speaker's voice-cloning clip) for
        reuse: ``start(prefix_id=...)`` then prefills only the new frames.
        The prefix's cache is sized for ``max_new_frames`` of decode."""
        ids, mask, S, Sb = _pad_to_bucket(np.asarray(input_ids), np.asarray(attention_mask,
                                                                           np.float32))
        dtype = self.params["backbone"]["final_norm"].dtype
        cache = csm.new_cache(self.config, ids.shape[0], _window(self.config, Sb + max_new_frames),
                              dtype=dtype, device=self.device)
        cache = _prefill_prefix(self.params, self.config, *self._tensors(ids, mask), cache, S,
                                first=True)
        pid = f"prefix-{self._prefix_seq}"
        self._prefix_seq += 1
        self._prefixes[pid] = (cache, S)
        return pid

    def drop_prefix(self, prefix_id) -> None:
        """Release a registered prefix's device memory."""
        self._prefixes.pop(prefix_id, None)

    @torch.no_grad()
    def start(self, input_ids, attention_mask, generator: Optional[torch.Generator] = None,
              max_new_frames: int = 1024, prefix_id=None) -> np.ndarray:
        """Prefill the prompt and emit the first frame ``[B, 32]``.  With
        ``prefix_id`` (:meth:`register_prefix`) ``input_ids`` is the
        continuation only; the prefix's cached K/V seed the session, whose
        frames equal the full-prompt session's."""
        from csm_tpu_torch.codec.streaming import StreamingMimiDecoder

        ids, mask, S, Sb = _pad_to_bucket(np.asarray(input_ids), np.asarray(attention_mask,
                                                                           np.float32))
        B = ids.shape[0]
        if prefix_id is not None:
            pre, S0 = self._prefixes[prefix_id]
            if pre.batch != B:
                raise ValueError(f"prefix batch ({pre.batch}) != session batch ({B})")
            if S0 + Sb + max_new_frames > pre.max_len:
                raise ValueError(
                    f"prefix window ({pre.max_len}) too small for {S0}+{Sb} prompt frames + "
                    f"{max_new_frames} new; register with a larger max_new_frames")
            cache = pre.clone()
        else:
            dtype = self.params["backbone"]["final_norm"].dtype
            cache = csm.new_cache(self.config, B, _window(self.config, Sb + max_new_frames),
                                  dtype=dtype, device=self.device)
        self._gen = generator
        out = generate_frame(self.params, self.config, *self._tensors(ids, mask), cache=cache,
                             generator=generator, true_len=S, flash_prefill=prefix_id is None,
                             **self._kw)
        self.cache = out.cache
        self._done = np.zeros((B,), bool)
        self._last_frame = out.samples
        if self.codec is not None:
            self._decoder = StreamingMimiDecoder(self.codec, batch=B)
        return self._observe(out.samples)

    @torch.no_grad()
    def step(self) -> Optional[np.ndarray]:
        """The next frame of every stream; None when every stream stopped."""
        if self._done.all():
            return None
        ids, mask = _next_frame_inputs(self.config, self._last_frame)
        out = generate_frame(self.params, self.config, ids, mask, cache=self.cache,
                             generator=self._gen, qbb=self._qbb, qsb=self._qsb, **self._kw)
        self.cache = out.cache
        self._last_frame = out.samples
        return self._observe(out.samples)

    def _observe(self, samples: torch.Tensor) -> np.ndarray:
        frame = samples.cpu().numpy()  # [B, 32]
        if self.stop_on_all_zeros:
            zero = (frame == 0).all(axis=1)
            frame = np.where(self._done[:, None], 0, frame)
            self._done |= zero
        return frame

    def decode_audio(self, frame: np.ndarray) -> Optional[np.ndarray]:
        """``[B, 32]`` frame codes -> ``[B, samples_per_frame]`` PCM."""
        if self._decoder is None:
            return None
        return self._decoder.feed(frame[:, :self.codec.num_codebooks, None])

    def run(self, input_ids, attention_mask, max_new_frames: int = 100,
            generator: Optional[torch.Generator] = None) -> Iterator[dict]:
        """Frames as they are made: ``{"frame": [B, 32], "audio": [B, hop] or
        None, "done": [B] bool}`` until every stream stops or the budget is
        spent."""
        frame = self.start(input_ids, attention_mask, generator=generator,
                           max_new_frames=max_new_frames)
        emitted = 0
        while frame is not None and emitted < max_new_frames:
            if self.stop_on_all_zeros and self._done.all() and (frame == 0).all():
                break
            yield {"frame": frame, "audio": self.decode_audio(frame), "done": self._done.copy()}
            emitted += 1
            if emitted >= max_new_frames:
                break
            frame = self.step()


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Request:
    rid: int
    ids: np.ndarray
    mask: np.ndarray
    generator: torch.Generator
    budget: int
    temperature: float
    topk: int
    greedy: bool
    prefix_id: Optional[str]
    submitted_ns: int  # time.perf_counter_ns() at submit


class CSMServer:
    """Slot-based continuous batching over a fixed decode batch.

    ``n_slots`` streams decode in lockstep as one ``[n_slots, 1, 33]`` frame
    step; requests are admitted into freed slots mid-flight with ragged
    prompt lengths.  Admission prefills the prompt at batch 1 and copies its
    K/V rows, validity and write index into its slot of the shared cache, in
    place; the other slots are untouched.

    - The shared cache (a ``KVCache``, or a hybrid backbone's
      ``HybridCache`` with each slot's recurrent states beside its K/V rows)
      carries a per-slot ``[n_slots]`` index: each slot sits at its own depth
      of the static window.  Admission writes the request's whole state into
      its slot, so nothing of a freed slot's last request reaches the next.
    - Each request draws from its own generator, with its own temperature /
      top-k / greedy (per-row vectors through every tier; a greedy request in
      a sampled batch is exactly argmax): its tokens equal its solo run.
    - Prefix caching (:meth:`register_prefix`, ``submit(prefix_id=)``): a
      shared context prefills once, each request only its continuation
      (the masked-bias path), with the full prompt's tokens; prefixes stack.
    - :meth:`cancel` frees a slot; finished slots keep stepping on stale
      inputs until admission overwrites them (the batch shape never changes).
    - Streaming audio (``codec=``): each slot owns a batch-1
      :class:`~csm_tpu_torch.codec.streaming.StreamingMimiDecoder`, reset at
      admission; each observed frame becomes 80 ms of PCM, and a finished
      request's waveform lands in :attr:`audio` beside its frames in
      :attr:`results`.  The stop frame is never voiced.
    """

    def __init__(self, params: dict, config: CSMConfig, n_slots: int = 8, window: int = 1024,
                 temperature: float = 1.0, topk: int = 50, greedy: bool = False,
                 stop_on_all_zeros: bool = True, max_new_frames: int = 100,
                 qdec: Optional[dict] = None, qbb: Optional[dict] = None,
                 qsb: Optional[dict] = None, codec=None, specdec: bool = False):
        self.params = params
        self.config = config
        self.n_slots = n_slots
        self.device = params["projection"].device
        # 128-aligned so the flash prefill can block the window.
        self.window = _window(config, window)
        self.greedy = greedy
        self.stop_on_all_zeros = stop_on_all_zeros
        self.default_max_new_frames = max_new_frames
        self._tiers = dict(qdec=qdec, qbb=qbb, qsb=qsb, specdec=specdec)

        dtype = params["backbone"]["final_norm"].dtype
        self._dtype = dtype
        cache = csm.new_cache(config, n_slots, self.window, dtype=dtype, device=self.device)
        self.cache = dataclasses.replace(
            cache, index=torch.zeros((n_slots,), dtype=torch.long, device=self.device))
        self._last = torch.zeros((n_slots, config.audio_num_codebooks), dtype=torch.long,
                                 device=self.device)
        # Free slots draw from a spare generator; their draws are discarded.
        self._idle_gen = torch.Generator(device=self.device)
        self._gens = [self._idle_gen] * n_slots

        self._slot_req = [None] * n_slots  # request id per slot
        self._depth = np.zeros(n_slots, np.int64)  # host mirror of the index
        self._budget = np.zeros(n_slots, np.int64)
        # Per-slot sampling parameters; the server's are the defaults.
        self._default_temp = float(np.float32(temperature))
        self._default_topk = int(topk)
        self._temp_v = np.full(n_slots, self._default_temp, np.float32)
        self._topk_v = np.full(n_slots, self._default_topk, np.int64)
        self._greedy_v = np.zeros(n_slots, bool)
        self._pending: list = []
        self._next_id = 0
        self.results: dict = {}
        self._frames: dict = {}
        self._prefixes: dict = {}  # prefix_id -> (seeded batch-1 cache, n_frames)
        self._prefix_seq = 0  # monotonic: ids are never reused after drop_prefix
        self._n_frames = 0
        self._n_prefills = 0
        self._n_prefix_prefills = 0

        self.codec = codec
        self._slot_dec = [None] * n_slots
        self.audio: dict = {}  # rid -> [n_samples] f32 PCM (finished)
        self._pcm: dict = {}  # rid -> per-frame chunks (running)
        self._n_audio_samples = 0

    # ------------------------------------------------------------------

    @property
    def active_slots(self):
        return [s for s in range(self.n_slots) if self._slot_req[s] is not None]

    def stats(self) -> dict:
        """Telemetry: slot occupancy, queue depth, frames emitted, prefill
        counts (split by prefix reuse) and per-slot context depths."""
        return {
            "n_slots": self.n_slots,
            "active_slots": len(self.active_slots),
            "queued": len(self._pending),
            "completed": len(self.results),
            "frames_emitted": int(self._n_frames),
            "audio_samples": int(self._n_audio_samples),
            "prefills": int(self._n_prefills),
            "prefix_prefills": int(self._n_prefix_prefills),
            "prefixes_registered": len(self._prefixes),
            "slot_depths": self._depth.tolist(),
            "window": self.window,
        }

    def _tensors(self, ids, mask):
        return (torch.as_tensor(ids, device=self.device).long(),
                torch.as_tensor(mask, device=self.device).float())

    def _empty_result(self, rid) -> None:
        self.results[rid] = np.zeros((0, self.config.audio_num_codebooks), np.int64)
        if self.codec is not None:
            self.audio[rid] = np.zeros((0,), np.float32)

    @torch.no_grad()
    def register_prefix(self, input_ids, attention_mask, prefix_id=None) -> str:
        """Prefill a shared conversation prefix once (a voice-cloning
        context) and keep its K/V on the device; requests submitted with
        ``prefix_id=`` start from it and prefill only their continuation.
        ``prefix_id`` here stacks the new frames on an existing prefix (the
        parent stays registered).  Each registration holds one window-sized
        batch-1 cache until :meth:`drop_prefix`."""
        ids = np.asarray(input_ids)
        mask = np.asarray(attention_mask, np.float32)
        if ids.shape[0] != 1:
            raise ValueError("register one conversation prefix at a time")
        parent, S0 = self._prefixes[prefix_id] if prefix_id is not None else (None, 0)
        if S0 + ids.shape[1] >= self.window:
            raise ValueError(f"prefix ({S0}+{ids.shape[1]}) must leave room in the window "
                             f"({self.window})")
        ids, mask, S, Sb = _pad_to_bucket(ids, mask, cap=self.window)
        if S0 + Sb > self.window:
            raise ValueError(f"parent prefix ({S0}) + bucket ({Sb}) exceed the window "
                             f"({self.window})")
        if parent is None:
            small = csm.new_cache(self.config, 1, self.window, dtype=self._dtype,
                                  device=self.device)
        else:
            small = parent.clone()
        cache = _prefill_prefix(self.params, self.config, *self._tensors(ids, mask), small, S,
                                first=parent is None)
        pid = f"prefix-{self._prefix_seq}"
        self._prefix_seq += 1
        self._prefixes[pid] = (cache, S0 + S)
        return pid

    def drop_prefix(self, prefix_id) -> None:
        """Release a registered prefix's device memory."""
        self._prefixes.pop(prefix_id, None)

    def submit(self, input_ids, attention_mask, generator: Optional[torch.Generator] = None,
               seed: Optional[int] = None, max_new_frames: Optional[int] = None,
               temperature: Optional[float] = None, topk: Optional[int] = None,
               greedy: bool = False, prefix_id=None) -> int:
        """Queue a request and admit it at once if a slot is free; returns
        its id (the key of :attr:`results`).  Its noise comes from
        ``generator`` (on the server's device), else from a new generator
        seeded with ``seed`` (default ``1000 + id``).  ``temperature`` /
        ``topk`` / ``greedy`` override the server's for this request (a
        server built with ``greedy=True`` is greedy for every request).
        ``prefix_id``: ``input_ids`` is the continuation of that prefix."""
        if prefix_id is not None and prefix_id not in self._prefixes:
            raise KeyError(f"unknown prefix_id {prefix_id!r}")
        rid = self._next_id
        self._next_id += 1
        with span("csm.serve.submit", rid=rid):
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(1000 + rid if seed is None else seed)
            self._pending.append(_Request(
                rid, np.asarray(input_ids), np.asarray(attention_mask, np.float32), generator,
                max_new_frames or self.default_max_new_frames,
                self._default_temp if temperature is None else float(np.float32(temperature)),
                self._default_topk if topk is None else int(topk), bool(greedy), prefix_id,
                time.perf_counter_ns()))
            self._drain_pending()
        return rid

    def _drain_pending(self):
        while self._pending:
            free = [s for s in range(self.n_slots) if self._slot_req[s] is None]
            if not free:
                return
            self._admit_request(free[0], self._pending.pop(0))

    @torch.no_grad()
    def _admit_request(self, slot: int, req: _Request):
        with span("csm.serve.admit", rid=req.rid, slot=slot, S=req.ids.shape[1],
                  queued_ms=(time.perf_counter_ns() - req.submitted_ns) / 1e6,
                  state_bytes=self.cache.state_bytes):
            self._admit(slot, req)

    def _admit(self, slot: int, req: _Request):
        if req.ids.shape[0] != 1:
            raise ValueError("submit one conversation per request")
        if req.prefix_id is not None:
            if req.prefix_id not in self._prefixes:
                # Dropped while the request sat in the queue: fail this
                # request softly, not the serving loop.
                warnings.warn(f"request {req.rid}: prefix {req.prefix_id!r} was dropped while "
                              "queued; recording an empty result")
                self._empty_result(req.rid)
                return
            pre, S0 = self._prefixes[req.prefix_id]
        else:
            pre, S0 = None, 0
        ids, mask, S, Sb = _pad_to_bucket(req.ids, req.mask, cap=self.window)
        if S0 + S > self.window:
            raise ValueError(f"prompt ({S0}+{S}) exceeds the serving window ({self.window})")
        if S0 + Sb > self.window:
            raise ValueError(f"prefix ({S0}) + continuation bucket ({Sb}) exceed the serving "
                             f"window ({self.window}); shorten one of them")
        if pre is None:
            small = csm.new_cache(self.config, 1, self.window, dtype=self._dtype,
                                  device=self.device)
        else:
            small = pre.clone()
        dev = self.device
        out = generate_frame(
            self.params, self.config, *self._tensors(ids, mask), cache=small,
            generator=[req.generator], true_len=S, flash_prefill=pre is None,
            temperature=torch.full((1,), req.temperature, device=dev),
            topk=torch.full((1,), req.topk, dtype=torch.long, device=dev), greedy=self.greedy,
            greedy_rows=None if self.greedy else torch.full((1,), req.greedy, device=dev),
            qdec=self._tiers["qdec"], specdec=self._tiers["specdec"])
        self._n_prefills += 1
        self._n_prefix_prefills += pre is not None
        # Scatter the prefilled slot into the shared cache, in place.
        self.cache.put(slot, out.cache)
        self.cache.index[slot] = S0 + S
        self._last[slot] = out.samples[0]
        self._gens[slot] = req.generator
        self._slot_req[slot] = req.rid
        self._depth[slot] = S0 + S
        self._budget[slot] = req.budget
        self._temp_v[slot] = req.temperature
        self._topk_v[slot] = req.topk
        self._greedy_v[slot] = req.greedy
        self._frames[req.rid] = []
        if self.codec is not None:
            from csm_tpu_torch.codec.streaming import StreamingMimiDecoder

            if self._slot_dec[slot] is None:
                self._slot_dec[slot] = StreamingMimiDecoder(self.codec, batch=1)
            else:
                self._slot_dec[slot].reset()
            self._pcm[req.rid] = []
        self._observe(slot, out.samples[0].cpu().numpy())

    def _observe(self, slot: int, frame: np.ndarray, drain: bool = True):
        rid = self._slot_req[slot]
        with span("csm.serve.observe", rid=rid, slot=slot):
            self._record_frame(slot, rid, frame, drain)

    def _record_frame(self, slot: int, rid: int, frame: np.ndarray, drain: bool):
        stopped = self.stop_on_all_zeros and not frame.any()
        if not stopped:
            self._frames[rid].append(frame.copy())
            if self.codec is not None:
                # One frame of codes -> one hop of PCM through this slot's
                # decoder; the stop frame (the end marker) is never voiced.
                chunk = self._slot_dec[slot].feed(frame[None, :self.codec.num_codebooks, None])
                self._pcm[rid].append(chunk[0])
                self._n_audio_samples += chunk.shape[-1]
            self._budget[slot] -= 1
            self._depth[slot] += 1
            self._n_frames += 1
        if stopped or self._budget[slot] <= 0 or self._depth[slot] >= self.window:
            self._finish(slot, drain=drain)

    def _finish(self, slot: int, drain: bool = True):
        rid = self._slot_req[slot]
        frames = self._frames.pop(rid)
        self.results[rid] = (np.stack(frames) if frames
                             else np.zeros((0, self.config.audio_num_codebooks), np.int64))
        if self.codec is not None:
            pcm = self._pcm.pop(rid, [])
            self.audio[rid] = np.concatenate(pcm) if pcm else np.zeros((0,), np.float32)
        self._slot_req[slot] = None
        self._gens[slot] = self._idle_gen
        if drain:
            self._drain_pending()

    def cancel(self, rid) -> bool:
        """Cancel a request: a queued one is dropped, a running one frees its
        slot; frames made so far land in :attr:`results` (possibly none).
        Returns True if the request was live."""
        for i, req in enumerate(self._pending):
            if req.rid == rid:
                self._pending.pop(i)
                self._empty_result(rid)
                return True
        for slot in range(self.n_slots):
            if self._slot_req[slot] == rid:
                self._finish(slot)
                return True
        return False

    def _frame_step(self) -> torch.Tensor:
        """One frame of every slot; returns the samples ``[n_slots, 32]`` on
        the device."""
        dev = self.device
        ids, mask = _next_frame_inputs(self.config, self._last)
        out = generate_frame(
            self.params, self.config, ids, mask, cache=self.cache, generator=list(self._gens),
            temperature=torch.from_numpy(self._temp_v).to(dev),
            topk=torch.from_numpy(self._topk_v).to(dev), greedy=self.greedy,
            greedy_rows=None if self.greedy else torch.from_numpy(self._greedy_v).to(dev),
            **self._tiers)
        self.cache = out.cache
        self._last = out.samples
        return out.samples

    @torch.no_grad()
    def step(self) -> bool:
        """Advance every live stream by one frame.  Returns False when no
        request is active or pending."""
        if not self.active_slots:
            self._drain_pending()
            if not self.active_slots:
                return False
        active_before = list(self.active_slots)
        B = len(active_before)
        with span("csm.serve.step", B=B):
            with span("csm.serve.frame", B=B):
                frames = self._frame_step().cpu().numpy()
            for s in active_before:
                self._observe(s, frames[s])
        return bool(self.active_slots or self._pending)

    @torch.no_grad()
    def step_many(self, n: int) -> bool:
        """Advance every live stream by up to ``n`` frames with one host read
        at the end.  A slot that stops mid-chunk has its later frames
        discarded; pending requests are admitted only after the chunk."""
        if not self.active_slots:
            self._drain_pending()
            if not self.active_slots:
                return False
        rid_at_start = list(self._slot_req)
        B = len(self.active_slots)
        with span("csm.serve.step", B=B, n=n):
            with span("csm.serve.frame", B=B, n=n):
                # [n, B, 32]
                frames = torch.stack([self._frame_step() for _ in range(n)]).cpu().numpy()
            for t in range(n):
                for s in range(self.n_slots):
                    if rid_at_start[s] is not None and self._slot_req[s] == rid_at_start[s]:
                        self._observe(s, frames[t, s], drain=False)
            self._drain_pending()
        return bool(self.active_slots or self._pending)

    def run_until_idle(self, max_steps: int = 10_000, chunk: int = 1) -> dict:
        """Drive the server until every submitted request has finished;
        ``chunk > 1`` steps through :meth:`step_many`."""
        steps = 0
        while steps < max_steps:
            alive = self.step_many(chunk) if chunk > 1 else self.step()
            steps += chunk
            if not alive:
                break
        return self.results
