"""EngineCore / Replica / InferenceEngine: continuous batching on one device
(``repro/serve/engine.py``, role "both", dense cache).

* :class:`EngineCore` — the device layer: prefill, fused decode and
  sampling over the slot cache.  ``prefill_batch`` runs one shared
  ``(k, bucket)`` prefill, replays each request's sub-bucket remainder
  through single-token decode steps, inserts the rows, and reports a
  :class:`PrefillOutcome` per row.
* :class:`Replica` — slot ownership, retirement and containment around
  one core: admit, one fused decode step over all slots, retire, backfill.
* :class:`InferenceEngine` — the public name of a single replica.

The router, disaggregated roles, paging and slot migration come with later
slices.  Greedy token streams equal the reference engine's on the same
weights (tests/test_torch_serve.py).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.models import model_zoo
from repro_torch.serve import sampling
from repro_torch.serve.policies import make_policy
from repro_torch.serve.scheduler import (Scheduler, SchedulerConfig,
                                         prefill_split)
from repro_torch.serve.state import SlotDecodeState
from repro_torch.serve.types import GenerationResult, PrefillOutcome, Request

OnToken = Callable[[int, int], None]  # (request uid, token id)

# per-step decode latency samples kept for percentiles (a bounded ring)
STEP_TIME_WINDOW = 2048


@dataclass
class EngineStats:
    """Host wall-clock accounting for one replica lifetime."""

    prefill_s: float = 0.0
    prefill_tokens: int = 0
    decode_s: float = 0.0
    decode_steps: int = 0
    generated_tokens: int = 0
    admitted: int = 0
    step_times: Deque[float] = field(
        default_factory=lambda: deque(maxlen=STEP_TIME_WINDOW))
    slot_errors: int = 0  # slots retired with reason "error"

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / max(self.prefill_s, 1e-9)

    @property
    def decode_tok_s(self) -> float:
        """Fused-decode tokens per second of fused-decode wall time (each
        request's first token comes from its admission prefill)."""
        return ((self.generated_tokens - self.admitted)
                / max(self.decode_s, 1e-9))

    def latency_percentile(self, p: float) -> float:
        """p-th percentile of per-step decode latency, seconds."""
        if not self.step_times:
            return 0.0
        return float(np.percentile(
            np.fromiter(self.step_times, np.float64), p))


class EngineCore:
    """The device layer: model, parameters and the slot cache on one device.

    Step times are host wall-clock around work that ends in a copy of the
    sampled tokens to the host, so they include the device's time.
    """

    def __init__(self, model, params, cfg: Optional[SchedulerConfig] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # serve in full fp32, as the reference does: no TF32 anywhere
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.params = params
        self.cfg = cfg or SchedulerConfig()
        self.state = SlotDecodeState(model)
        self.ladder = self.cfg.ladder()
        self.vocab = model.cfg.vocab_size
        self.cache = self.state.init_slots(self.cfg.n_slots,
                                           self.cfg.cache_len,
                                           params["embed"].dtype, self.device)

    def _tensor(self, x, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # -- sampling ------------------------------------------------------------
    def _first_token(self, req: Request, logits: torch.Tensor,
                     generator: torch.Generator) -> int:
        """Sample the admission token from one request's (1, V) logits."""
        sp = req.sampling
        if sp.temperature <= 0.0:
            return int(sampling.greedy(logits, self.vocab)[0])
        return int(sampling.sample_tokens(
            logits, self._tensor([sampling.draw_uniform(generator)],
                                 torch.float32),
            self._tensor([sp.temperature], torch.float32),
            self._tensor([sp.top_k]),
            self._tensor([sp.top_p], torch.float32), self.vocab)[0])

    # -- admission prefill ---------------------------------------------------
    def prefill_batch(self, admissions) -> List[PrefillOutcome]:
        """Prefill same-split requests as one ``(k, bucket)`` call, replay
        each ragged remainder, insert the surviving rows, sample each first
        token.  Returns one :class:`PrefillOutcome` per admission row."""
        reqs = [r for _, r in admissions]
        outcomes = [PrefillOutcome(slot=s, request=r) for s, r in admissions]
        try:
            split = prefill_split(reqs[0].prompt_len, self.ladder)
            toks = self._tensor([r.tokens[:split] for r in reqs])
            logits, kcache = self.model.prefill(
                self.params, {"tokens": toks}, cache_len=self.cfg.cache_len)
        except Exception:  # noqa: BLE001 — shared phase: all k rows fail
            for o in outcomes:
                o.error = "prefill"
            return outcomes
        row_logits = [logits[i:i + 1] for i in range(len(reqs))]
        if any(r.prompt_len > split for r in reqs):
            rows = [self.state.row(kcache, i) for i in range(len(reqs))]
            for i, r in enumerate(reqs):
                try:
                    full = self._tensor(r.tokens)[None, :]
                    for j in range(split, r.prompt_len):
                        row_logits[i], rows[i] = self.state.decode(
                            self.params, rows[i], full[:, j:j + 1])
                except Exception:  # noqa: BLE001 — this request only
                    outcomes[i].error = "replay"
            live = [i for i in range(len(reqs)) if not outcomes[i].error]
            stacked = (self.state.stack_rows([rows[i] for i in live])
                       if live else None)
        else:
            live = list(range(len(reqs)))
            stacked = kcache
        if stacked is not None:
            self.cache = self.state.insert_many(
                self.cache, self._tensor([outcomes[i].slot for i in live]),
                stacked)
        for i in live:
            sp = reqs[i].sampling
            gen = sampling.request_generator(sp.seed, reqs[i].uid)
            outcomes[i].generator = gen
            try:
                outcomes[i].first_token = self._first_token(
                    reqs[i], row_logits[i], gen)
            except Exception:  # noqa: BLE001 — per-request sampling fault
                outcomes[i].error = "sample"
        return outcomes

    def evict(self, slot: int) -> None:
        self.cache = self.state.evict(self.cache, slot)

    # -- the fused decode step (device half) --------------------------------
    def decode_step(self, toks: np.ndarray, uniforms: np.ndarray,
                    temps: np.ndarray, topk: np.ndarray, topp: np.ndarray,
                    all_greedy: bool) -> np.ndarray:
        """One fused decode + sample over all slots -> (n_slots,) tokens.
        Inactive rows compute values nobody reads (their cache rows are
        kept by the ``active`` mask)."""
        logits, self.cache = self.state.decode(self.params, self.cache,
                                               self._tensor(toks))
        if all_greedy:
            return sampling.greedy(logits, self.vocab).cpu().numpy()
        return sampling.sample_tokens(
            logits, self._tensor(uniforms, torch.float32),
            self._tensor(temps, torch.float32), self._tensor(topk),
            self._tensor(topp, torch.float32), self.vocab).cpu().numpy()


class Replica:
    """Slot ownership + retirement + containment around one EngineCore."""

    def __init__(self, model, params, cfg: Optional[SchedulerConfig] = None,
                 device="cuda"):
        self.cfg = cfg or SchedulerConfig()
        self.stats = EngineStats()
        self.core = EngineCore(model, params, self.cfg, device=device)
        self.scheduler = Scheduler(self.cfg)
        self.policy = make_policy(self.cfg)
        n = self.cfg.n_slots
        # fused-step staging, refreshed in place; stale rows are harmless
        self._toks = np.zeros((n, 1), np.int64)
        self._temps = np.zeros((n,), np.float32)
        self._topk = np.zeros((n,), np.int64)
        self._topp = np.ones((n,), np.float32)
        self._uniforms = np.zeros((n,), np.float32)

    @classmethod
    def from_arch(cls, arch: str, use_reduced: bool = True, seed: int = 0,
                  cfg: Optional[SchedulerConfig] = None,
                  decode_backend: Optional[str] = None,
                  attn_backend: Optional[str] = None,
                  device="cuda") -> "Replica":
        """Replica over random fp32 weights drawn from ``seed``."""
        from repro_torch.configs import get_arch, reduced as reduce_cfg
        dev = resolve_device(device)
        mcfg = get_arch(arch)
        mcfg = reduce_cfg(mcfg) if use_reduced else mcfg
        if decode_backend:
            mcfg = mcfg.replace(decode_backend=decode_backend)
        if attn_backend:
            mcfg = mcfg.replace(attn_backend=attn_backend)
        model = model_zoo.build_model(mcfg)
        params = model_zoo.init_params(
            mcfg, torch.Generator().manual_seed(seed), dev)
        return cls(model, params, cfg=cfg, device=dev)

    @property
    def model(self):
        return self.core.model

    @property
    def params(self):
        return self.core.params

    @property
    def cache(self):
        return self.core.cache

    # -- admission -----------------------------------------------------------
    def _admit_batch(self, admissions, on_token: Optional[OnToken]) -> None:
        t0 = time.perf_counter()
        outcomes = self.core.prefill_batch(admissions)
        if all(o.error == "prefill" for o in outcomes):
            for o in outcomes:
                self.core.evict(o.slot)
                self.scheduler.abort(o.slot, o.request)
                self.stats.slot_errors += 1
            return
        dt = time.perf_counter() - t0
        n_ok = sum(1 for o in outcomes if not o.error)
        self.stats.prefill_s += dt
        self.stats.prefill_tokens += sum(o.request.prompt_len
                                         for o in outcomes if not o.error)
        self.stats.admitted += n_ok
        self.stats.generated_tokens += n_ok
        for o in outcomes:
            if o.error:
                self.core.evict(o.slot)
                self.scheduler.abort(o.slot, o.request)
                self.stats.slot_errors += 1
                continue
            st = self.scheduler.activate(o.slot, o.request, o.first_token,
                                         dt / max(n_ok, 1), o.generator)
            try:
                if on_token:
                    on_token(o.request.uid, o.first_token)
                reason = self.scheduler.stop_reason(st)
            except Exception:  # noqa: BLE001 — consumer callback fault
                self._retire(o.slot, "error")
                self.stats.slot_errors += 1
                continue
            if reason:
                self._retire(o.slot, reason)

    def _retire(self, slot: int, reason: str) -> GenerationResult:
        self.core.evict(slot)
        res = self.scheduler.finish(slot, reason)
        res.decode_steps = max(len(res.tokens) - 1, 0)
        return res

    def admit(self, on_token: Optional[OnToken] = None) -> bool:
        """One admission round; False when nothing was admissible."""
        adm = self.policy.select(self.scheduler, self.cfg.prefill_batch)
        if not adm:
            return False
        self._admit_batch(adm, on_token)
        return True

    # -- the fused decode step ---------------------------------------------
    def step(self, on_token: Optional[OnToken] = None) -> None:
        """One fused decode step over the active slots."""
        active_now = list(self.scheduler.active.items())
        all_greedy = True
        for slot, st in active_now:
            sp = st.request.sampling
            self._toks[slot, 0] = st.last_token
            self._temps[slot] = sp.temperature
            self._topk[slot] = sp.top_k
            self._topp[slot] = sp.top_p
            if sp.temperature > 0.0:
                all_greedy = False
                self._uniforms[slot] = sampling.draw_uniform(st.generator)
        t0 = time.perf_counter()
        nxt = self.core.decode_step(self._toks, self._uniforms, self._temps,
                                    self._topk, self._topp, all_greedy)
        dt = time.perf_counter() - t0
        self.stats.step_times.append(dt)
        self.stats.decode_s += dt
        self.stats.decode_steps += 1
        self.stats.generated_tokens += len(active_now)
        for slot, st in active_now:
            try:
                tok = int(nxt[slot])
                st.result.tokens.append(tok)
                st.last_token = tok
                if on_token:
                    on_token(st.request.uid, tok)
                reason = self.scheduler.stop_reason(st)
            except Exception:  # noqa: BLE001 — retire only this slot
                self._retire(slot, "error")
                self.stats.slot_errors += 1
                continue
            if reason:
                self._retire(slot, reason)

    # -- run loop ------------------------------------------------------------
    def pump(self, on_token: Optional[OnToken] = None) -> bool:
        progressed = False
        while self.admit(on_token):
            progressed = True
        if self.scheduler.active:
            self.step(on_token)
            progressed = True
        return progressed

    def run(self, requests: Sequence[Request],
            on_token: Optional[OnToken] = None) -> List[GenerationResult]:
        """Generate for all ``requests``; results in request order.
        Validation is all-or-nothing."""
        requests = list(requests)
        self.scheduler.validate_batch(requests)
        backlog = deque(requests)
        while backlog or self.scheduler.busy:
            while backlog and self.scheduler.has_room:
                self.scheduler.enqueue_validated(backlog.popleft())
            self.pump(on_token)
        done = self.take_finished()
        by_uid: Dict[int, GenerationResult] = {r.uid: r for r in done}
        return [by_uid[r.uid] for r in requests]

    def take_finished(self) -> List[GenerationResult]:
        done, self.scheduler.finished = self.scheduler.finished, []
        return done

    def reset_stats(self) -> EngineStats:
        old, self.stats = self.stats, EngineStats()
        return old


class InferenceEngine(Replica):
    """Single-device continuous-batching engine (one ``Replica``)."""
