"""The serving drivers' shared parts: the model and its weights from the
configuration file, the paged engine from the workload file, the loop
that submits requests between ticks and times them, and the check of
served tokens against the reference.

A request's first-token and last-token times are the host clock when the
tick that produced them returned.  Requests due (open loop) or sent
(closed loop) inside the window are followed past its close until they
finish, for at most `drain_s`; the load goes on meanwhile, and nothing
after the close counts towards a rate.

The check's requests are chosen from the seed before the window (open
loop: the longest request due in it and others drawn from the seed;
closed loop: the turns of users drawn from the seed), and after each tick
the row of the engine's logits (`last_logits`) at the position each of
them fed is copied to the host: the program's own logits, compared with
the reference's after the window.
"""
from __future__ import annotations

import gc
import math
import time
from collections import deque
from dataclasses import dataclass, field

from portbench import bench, traffic
from portbench.reference import phi3 as ref_phi3
from portbench.reference import strict_float32


def arch_config(cfg: dict):
    """The program's ArchConfig for the configuration file (dense, SwiGLU,
    untied, no sliding window: none of the cells reaches the published
    one)."""
    from repro_torch.configs.base import ArchConfig
    if cfg["hidden_act"] != "silu" or cfg["head_dim"] * cfg["num_attention_heads"] == 0:
        raise bench.BenchError(f"{cfg['name']}: not a SwiGLU decoder")
    return ArchConfig(name=cfg["name"], family="dense", n_layers=cfg["num_hidden_layers"],
                      d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
                      n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
                      d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"], act="swiglu",
                      rope_theta=cfg["rope_theta"],
                      tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
                      source=cfg["source"])


def weight_shapes(cfg: dict) -> dict:
    """The stacked layout the program's decoder takes (models/lm.py)."""
    L, d, f, v = (cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"],
                  cfg["vocab_size"])
    qd = cfg["num_attention_heads"] * cfg["head_dim"]
    kvd = cfg["num_key_value_heads"] * cfg["head_dim"]
    return {"embed": (v, d), "final_norm": (d,), "unembed": (v, d),
            "blocks": {"sub0": {"ln1": (L, d), "ln2": (L, d),
                                "attn": {"wq": (L, d, qd), "wk": (L, d, kvd),
                                         "wv": (L, d, kvd), "wo": (L, qd, d)},
                                "mlp": {"wg": (L, d, f), "wu": (L, d, f), "wd": (L, f, d)}}}}


def _scale(path: tuple, shape: tuple) -> float | None:
    """Normal * scale for a weight (None: a norm gain, all ones)."""
    name = path[-1]
    if name in ("ln1", "ln2", "final_norm"):
        return None
    if name in ("embed", "unembed"):
        return 0.02
    return shape[-2] ** -0.5


def make_weights(torch, cfg: dict, seed: int, device) -> dict:
    """The weights in the configuration's dtype, drawn on `device` from the
    seed, one call per stacked tensor."""
    dtype = getattr(torch, cfg["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed((seed + 11) % (1 << 63))

    def build(shapes, path):
        out = {}
        for k, shape in shapes.items():
            if isinstance(shape, dict):
                out[k] = build(shape, path + (k,))
                continue
            t = torch.empty(shape, dtype=dtype, device=device)
            s = _scale(path + (k,), shape)
            if s is None:
                t.fill_(1.0)
            else:
                t.normal_(0.0, s, generator=gen)
            out[k] = t
        return out

    return build(weight_shapes(cfg), ())


def check_layout(cfg: dict, arch) -> None:
    """The program's decoder takes the stacked layout `weight_shapes` makes."""
    from repro_torch.models import lm

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    got = shapes(lm.init_params(arch, device="meta"))
    if got != weight_shapes(cfg):
        raise bench.BenchError(f"the program's decoder takes {got}, not the harness's layout")


def make_engine(arch, params, wl: dict):
    from repro_torch.serve import PagedServingEngine, ServeConfig
    sc = ServeConfig(**wl["serve"])
    # eos -1: no token ends a request; each stops at its stated length
    return PagedServingEngine(arch, params, sc, eos_id=-1)


def kv8_engine(arch, params, wl: dict):
    """The engine with the program's float8 e4m3 KV cache, the program's
    own step below the bfloat16 the configuration states (read as a
    candidate control by calibrate.py --kv8)."""
    import dataclasses
    return make_engine(dataclasses.replace(arch, kv_cache_dtype="float8_e4m3fn"), params, wl)


@dataclass
class Served:
    req: traffic.Request
    handle: object
    sent: float                   # due (open loop) or sent (closed loop), host clock
    first: float = math.nan
    last: float = math.nan
    n: int = 0
    done: bool = False
    watched: bool = False         # the program's logits are kept for the check
    logits: dict = field(default_factory=dict)   # fed position -> logits row (host)


class Loop:
    """Submits requests between ticks, ticks the engine, and records each
    request's token times, the tick spans and the counters the per-layer
    readers read.  With `traced`, `trace_ticks` ticks right after the
    window's close run under the profiler (the load still on), so that the
    profiler's cost falls outside the window."""

    def __init__(self, torch, eng, *, seconds: float, drain_s: float, traced: bool,
                 trace_ticks: int, device):
        self.torch, self.eng = torch, eng
        self.seconds, self.drain_s = seconds, drain_s
        self.traced, self.trace_ticks = traced, trace_ticks
        self.cuda = device.type == "cuda"
        self.records: list[Served] = []      # in submission order
        self.live: dict[int, Served] = {}
        self.ticks: list[dict] = []         # window ticks outside the profiled slice
        self.trace = None
        self.slice_ticks: list[dict] = []
        self.late_s = 0.0
        self.watched: dict[int, Served] = {}     # live requests whose logits are kept
        self.pool_peak = 0                       # KV blocks held by requests, most in a tick

    def submit(self, req: traffic.Request, sent: float, watch: bool = False) -> Served:
        h = self.eng.submit(req.prompt, max_new_tokens=req.max_new)
        s = Served(req, h, sent, watched=watch)
        self.live[h.rid] = s
        if watch:
            self.watched[h.rid] = s
        self.records.append(s)
        return s

    def _fed(self) -> list[tuple[int, int, int]]:
        """(slot, rid, position) of each watched request in a slot."""
        return [(i, s["rid"], int(self.eng.pos[i])) for i, s in enumerate(self.eng.slots)
                if s is not None and s["rid"] in self.watched]

    def _keep_logits(self, before: list[tuple[int, int, int]]) -> None:
        """Copy the tick's logits row of each watched request that fed a
        position in it: those in a slot before the tick (unless the slot
        still holds them at the same position: not scheduled), and those
        the tick admitted (they fed the position before their new one)."""
        eng, rows = self.eng, []
        seen = set()
        for i, rid, p in before:
            s = eng.slots[i]
            seen.add(rid)
            if s is None or s["rid"] != rid or int(eng.pos[i]) != p:
                rows.append((i, rid, p))
        rows += [(i, rid, p - 1) for i, rid, p in self._fed() if rid not in seen]
        if rows:
            got = eng.last_logits[[i for i, _, _ in rows]].float().cpu()
            for k, (_, rid, p) in enumerate(rows):
                self.watched[rid].logits[p] = got[k]

    def _tick(self, prof=None) -> dict:
        eng = self.eng
        steps0, toks0 = eng.decode_steps, eng.tokens_out
        before = self._fed() if self.watched else None
        a = time.perf_counter()
        if prof is None:
            eng.tick()
        else:
            with prof.span("tick"):
                eng.tick()
        b = time.perf_counter()
        if before is not None:
            self._keep_logits(before)
        if eng.pool is not None:
            self.pool_peak = max(self.pool_peak, eng.pool.active_count)
        finished = []
        for rid, s in list(self.live.items()):
            n = len(s.handle.tokens())
            if n > s.n:
                if s.n == 0:
                    s.first = b
                s.last, s.n = b, n
            if s.handle.done():
                s.done = s.handle.error() is None
                del self.live[rid]
                self.watched.pop(rid, None)
                finished.append(s)
        slots = sum(x is not None for x in eng.slots)
        return {"t0": a, "t1": b, "steps": eng.decode_steps - steps0,
                "tokens": eng.tokens_out - toks0, "finished": finished,
                "active": slots + len(finished), "pos": eng.pos.copy()}

    def run(self, feed) -> None:
        """The window and its drain: `feed.due(loop, now)` submits what has
        come due before each tick, `feed.finished(loop, served, now)` hears
        of each request that a tick finished."""
        eng = self.eng
        t0 = time.perf_counter()
        self.t0, self.win_end = t0, t0 + self.seconds
        hard_end = self.win_end + self.drain_s
        self.snap0 = self.counters()
        self.pool_peak = 0
        self.snap1 = None
        while True:
            now = time.perf_counter()
            feed.due(self, now)
            if now >= self.win_end:
                if self.snap1 is None:
                    self.snap1 = self.counters()
                    if self.traced and self.cuda:
                        self._profile(feed)
                owed = [s for s in self.records if s.sent < self.win_end and s.handle.rid in
                        self.live]
                if not owed or now >= hard_end:
                    self.drain_took = now - self.win_end
                    break
            if eng.pending() == 0:
                time.sleep(0.0002)
                continue
            t = self._tick()
            if t["t1"] <= self.win_end:
                self.ticks.append(t)
            for s in t["finished"]:
                feed.finished(self, s, t["t1"])

    def _profile(self, feed) -> None:
        with bench.Profiled(self.torch) as prof:
            for _ in range(self.trace_ticks):
                if self.eng.pending() == 0:
                    break
                with prof.span("submit"):
                    feed.due(self, time.perf_counter())
                t = self._tick(prof)
                self.slice_ticks.append(t)
                for s in t["finished"]:
                    feed.finished(self, s, t["t1"])
        self.trace = prof.trace
        self.trace.units = {"steps": sum(t["steps"] for t in self.slice_ticks)}

    def counters(self) -> dict:
        eng = self.eng
        pc = eng.prefix.stats() if eng.prefix_enabled else {"hits": 0}
        return {"hits": pc["hits"], "admitted": eng.scheduler.admitted,
                "waiting": len(eng.scheduler.waiting)}

    # -- what the window measured -------------------------------------------
    def in_window(self) -> list[Served]:
        return [s for s in self.records if self.t0 <= s.sent < self.win_end]

    def end_to_end(self) -> dict:
        reqs = [s for s in self.in_window() if s.done]
        ttft = [1e3 * (s.first - s.sent) for s in reqs]
        tpot = [1e3 * (s.last - s.first) / (s.n - 1) for s in reqs if s.n > 1]
        toks = sum(t["tokens"] for t in self.ticks) + sum(
            t["tokens"] for t in self.slice_ticks if t["t1"] <= self.win_end)
        out = {"ttft_p90_ms": bench.quantile(ttft, 0.9), "tpot_p90_ms": bench.quantile(tpot, 0.9),
               "out_tok_s": toks / self.seconds}
        self.samples = {"ttft": len(ttft), "tpot": len(tpot)}
        return out

    def observations(self, cfg: dict, wl: dict, peaks: dict) -> dict:
        steps = sum(t["steps"] for t in self.ticks)
        a0, a1 = self.snap0["admitted"], self.snap1["admitted"]
        admitted = self.records[a0:a1]       # admission is first come, first served
        prompt_tokens = sum(len(s.req.prompt) for s in admitted)
        bs = wl["serve"]["block_size"]
        return {
            "config": cfg, "serve": wl["serve"], "peaks": peaks, "trace": self.trace,
            "step_ms": 1e3 * sum(t["t1"] - t["t0"] for t in self.ticks) / steps if steps else None,
            "prefix_hit": (100.0 * (self.snap1["hits"] - self.snap0["hits"]) * bs / prompt_tokens
                           if prompt_tokens else None),
            "backlog": self.snap1["waiting"],
            "occupancy": (100.0 * sum(t["active"] for t in self.ticks)
                          / (len(self.ticks) * wl["serve"]["batch"]) if self.ticks else None),
            "slice_ticks": [{"steps": t["steps"], "active": t["active"],
                             "valid": [max(int(p), 1) for p in t["pos"]]}
                            for t in self.slice_ticks],
        }


def sample(loop: Loop) -> list[Served]:
    """The watched requests of the window that finished, with their
    logits kept: what the check compares."""
    return [s for s in loop.in_window() if s.watched and s.done and s.n and s.logits]


# positions counted as a request's first (`logit_err.early`, not compared)
EARLY = 8


def _rel_err(got, ref):
    """Per row: the RMS of got - ref over the RMS of ref about its mean."""
    spread = (ref - ref.mean(-1, keepdim=True)).square().mean(-1).sqrt()
    return (got - ref).square().mean(-1).sqrt() / spread


def judge(torch, cfg: dict, params: dict, picked: list[Served],
          control: bool = False) -> tuple[dict[str, float], dict[str, float]]:
    """Two numbers, each the worst over the picked requests: `logit_gap`,
    the widest gap of a served token's reference logit below the
    reference's best; `logit_err`, the largest at any fed position of the
    program's logits' distance from the reference's (`_rel_err`).  With
    `control`, the same of the e4m3 control (the reference in e4m3 put in
    the program's place: the tokens it puts first, and its logits).
    Beside them, not compared: the mean gap, the share of tokens off the
    reference's first choice, the median `logit_err`, and its largest at
    the first `EARLY` positions of requests fed from position 0."""
    strict_float32()
    seqs = [s.req.prompt + s.handle.tokens() for s in picked]
    firsts = [min(s.logits) for s in picked]          # the first fed position
    starts = [len(s.req.prompt) for s in picked]
    with torch.no_grad():
        ref = ref_phi3.logits_at(cfg, params, seqs, [f + 1 for f in firsts])
        low = (ref_phi3.logits_at(cfg, params, seqs, [f + 1 for f in firsts], "float8_e4m3fn")
               if control else None)
        served = [r[st - 1 - f:] for r, st, f in zip(ref, starts, firsts)]
        readings, stats = {}, {}
        picks = {"logit_gap": None}
        if control:
            picks["logit_gap.control"] = [lo[st - 1 - f:].argmax(-1)
                                          for lo, st, f in zip(low, starts, firsts)]
        for name, pick in picks.items():
            g = ref_phi3.gaps(served, seqs, starts, pick)
            readings[name] = float(g.max())
            stats[name + ".mean"] = float(g.mean())
            stats[name + ".off"] = float((g > 0).float().mean())
        errs = {"logit_err": [], "logit_err.control": []}
        for k, s in enumerate(picked):
            pos = sorted(s.logits)
            rows = [p - firsts[k] for p in pos]
            r = ref[k][rows]
            errs["logit_err"].append(_rel_err(torch.stack([s.logits[p] for p in pos])
                                              .to(r.device), r))
            if control:
                errs["logit_err.control"].append(_rel_err(low[k][rows], r))
            if pos[0] == 0:               # positions whose attention spans few others
                early = errs["logit_err"][-1][:EARLY]
                stats["logit_err.early"] = max(stats.get("logit_err.early", 0.0),
                                               float(early.max()))
        for name, e in errs.items():
            if e:
                e = torch.cat(e)
                readings[name] = float(e.max())
                stats[name + ".median"] = float(e.median())
                stats[name + ".positions"] = int(e.numel())
    return readings, stats


def serve_cell(cell, *, seed: int, seconds: float, traced: bool, device, process_start: float,
               feed_of, warm, control: bool = False, program=None) -> bench.Outcome:
    """A serving cell end to end: weights, engine and warm-up (set-up), the
    window and its drain, the memory peak, the engine freed, the check."""
    import torch
    cfg, wl = cell.config, cell.workload
    cuda = device.type == "cuda"
    arch = arch_config(cfg)
    check_layout(cfg, arch)
    params = make_weights(torch, cfg, seed, device)
    eng = (program or make_engine)(arch, params, wl)
    feed = feed_of(wl, seed, seconds, cfg["vocab_size"])
    warm(eng, feed)
    if cuda:
        torch.cuda.synchronize(device)
    graphs0 = eng.graph_stats()["graphs"] if cuda else 0
    setup_s = time.time() - process_start
    bench.log(f"{cell.name}: set-up {setup_s:.2f} s, window {seconds} s, "
              f"{eng.pool.num_blocks if eng.pool else 0} KV blocks")
    loop = Loop(torch, eng, seconds=seconds, drain_s=wl["drain_s"], traced=traced,
                trace_ticks=wl["trace_ticks"], device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    loop.run(feed)
    if cuda:
        torch.cuda.synchronize(device)
    captured = (eng.graph_stats()["graphs"] - graphs0) if cuda else 0
    if captured:
        raise bench.BenchError(f"{captured} tick graphs were captured inside the window")
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    stats = eng.stats()
    window = loop.in_window()
    failed = sum(not s.done for s in window)
    e2e = loop.end_to_end() if len(window) > failed else {}
    e2e["setup_s"] = setup_s
    peaks = bench.peaks(torch.cuda.get_device_name(device) if cuda else "")
    obs = loop.observations(cfg, wl, peaks)
    picked = sample(loop)
    pool = eng.pool
    obs["pool"] = ({"peak_blocks": loop.pool_peak, "blocks": pool.num_blocks,
                    "block_bytes": eng.executor.block_bytes} if pool is not None else None)
    notes = [f"{cell.name}: {len(window)} requests in the window, {failed} failed or unfinished,"
             f" samples {getattr(loop, 'samples', {})}, {len(loop.ticks)} ticks, "
             f"backlog {obs['backlog']}, preemptions {stats['scheduler']['preemptions']}, "
             f"check on {len(picked)} requests ({sum(s.n for s in picked)} served tokens, "
             f"{sum(len(s.logits) for s in picked)} positions), "
             f"arrivals at most {1e3 * loop.late_s:.1f} ms late",
             f"{cell.name}: KV pool {obs['pool']} (peak blocks held by requests in the window), "
             f"memory peak in the window {memory_peak} bytes"]
    free(torch, eng, loop)

    t_check = time.perf_counter()
    readings, stats = judge(torch, cfg, params, picked, control) if picked else (
        {"logit_gap": math.inf, "logit_err": math.inf}, {})
    obs["check_stats"] = stats
    notes.append(f"{cell.name}: the check took {time.perf_counter() - t_check:.2f} s, the "
                 f"drain {loop.drain_took:.2f} s; beside the checks {stats}")
    checks = [bench.Check(k, v, wl["limits"][k.split(".")[0]]) for k, v in readings.items()]
    return bench.Outcome(attempted=len(window), failed=failed, end_to_end=e2e, obs=obs,
                         checks=checks, memory_peak_bytes=memory_peak, trace=loop.trace,
                         notes=notes)


class OpenFeed:
    """Open loop: each request is submitted once its due time has come
    (between ticks), timed from its due time.  Watched for the check: the
    longest request (prompt and output) due in the window, and
    `check_requests` - 1 others due in it, drawn from the seed."""

    def __init__(self, wl: dict, seed: int, seconds: float, vocab: int):
        reqs = traffic.open_loop(wl["traffic"], seed, seconds, wl["drain_s"], vocab)
        inside = [i for i, r in enumerate(reqs) if r.due < seconds]
        longest = max(inside, key=lambda i: (len(reqs[i].prompt) + reqs[i].max_new, -i))
        rest = [i for i in inside if i != longest]
        order = traffic.rng(seed, 9).permutation(len(rest))
        self.watch = {id(reqs[i]) for i in [longest] + [rest[k] for k in
                                                        order[:wl["check_requests"] - 1]]}
        self.queue = deque(reqs)

    def due(self, loop: Loop, now: float) -> None:
        while self.queue and loop.t0 + self.queue[0].due <= now:
            r = self.queue.popleft()
            loop.late_s = max(loop.late_s, now - (loop.t0 + r.due))
            loop.submit(r, loop.t0 + r.due, watch=id(r) in self.watch)

    def finished(self, loop: Loop, s: Served, now: float) -> None:
        pass


class ClosedFeed:
    """Closed loop: each user sends its next turn as soon as its reply is
    finished, timed from when it was sent.  Watched for the check: the
    turns sent in the window by `check_users` users drawn from the seed, at
    most `check_requests` of them."""

    def __init__(self, wl: dict, seed: int, seconds: float, vocab: int):
        self.sessions = traffic.Sessions(wl["traffic"], seed, vocab, wl["serve"]["max_len"])
        users = wl["traffic"]["users"]
        self.watch = set(traffic.rng(seed, 9).permutation(users)[:wl["check_users"]].tolist())
        self.budget = wl["check_requests"]
        self.started = False

    def send(self, loop: Loop, user: int, now: float) -> None:
        watch = user in self.watch and self.budget > 0 and now < loop.win_end
        self.budget -= watch
        loop.submit(self.sessions.next(user), now, watch=watch)

    def due(self, loop: Loop, now: float) -> None:
        if not self.started:
            self.started = True
            for u in sorted(self.sessions.history):
                self.send(loop, u, now)

    def finished(self, loop: Loop, s: Served, now: float) -> None:
        self.sessions.replied(s.req, s.handle.tokens())
        self.send(loop, s.req.user, now)


def free(torch, eng, loop=None) -> None:
    """Drop the engine (its pools, graphs and the prefix cache's reference
    cycle) and return its memory to the card."""
    eng.slots = eng._steps = eng.kp = eng.vp = eng._pools = eng.pool = eng.prefix = None
    if loop is not None:
        loop.eng = None
    del eng
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_until_idle(eng, max_ticks: int = 100_000) -> None:
    for _ in range(max_ticks):
        if eng.tick() == 0:
            return
    raise bench.BenchError("warm-up did not finish")
