"""Tick planner for the paged serving engine: chunked prefill mixed into
decode ticks under a token budget, FCFS admission gated on pool capacity,
and preemption-by-recompute when the pool runs dry mid-stream.

One engine tick runs ONE compiled program over the whole slot batch; the
scheduler's job is to decide, host-side, how many tokens each slot feeds
into that program:

  * decoding slots get 1 token each, FIRST -- decode progress is never
    starved by a long prompt;
  * prefilling slots then split the remaining budget in admission order,
    at most `prefill_chunk` tokens each (chunked prefill: a 10k-token
    prompt is fed over many ticks while other slots keep decoding).

Admission (FCFS, `waiting` is a deque): a request leaves the queue only
when a slot is free AND the pool can cover its full prompt blocks minus
whatever the prefix cache already holds, plus one block of decode margin.
Requests that can never fit (prompt longer than the pool or the engine's
max_len) are failed immediately rather than parked forever.

Preemption: when a mid-stream allocation still fails (decode grew past the
admission margin), the NEWEST admitted slot is torn down and its request --
prompt plus everything generated so far -- goes back to the FRONT of the
queue.  Greedy decoding makes the recompute exact, so a preempted request's
final output is identical to an undisturbed run.

Backpressure + deadlines (docs/SERVING.md "Failure model"): the waiting
queue is optionally BOUNDED (`max_queue`; `submit` returns False when full
and the engine raises QueueFull), and requests may carry an absolute
deadline -- `expire(now)` culls queued-past-deadline requests before they
waste prefill budget; the engine evicts in-flight expired slots itself.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .block_pool import BlockPool


@dataclass
class Request:
    rid: int
    prompt: list[int]
    handle: "object" = None            # serve.engine.RequestHandle
    max_new: int | None = None
    resume_out: list[int] = field(default_factory=list)
    deadline: float | None = None      # absolute clock() time; None = never

    @property
    def feed(self) -> list[int]:
        """Token stream to teacher-force: prompt, then (on a preemption
        recompute) the tokens already generated before the preemption."""
        return self.prompt + self.resume_out


def blocks_for(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)


class Scheduler:
    """Host-side planning state: waiting queue + per-tick token budgeting."""

    def __init__(self, *, block_size: int, prefill_chunk: int,
                 token_budget: int | None, n_slots: int,
                 max_queue: int | None = None):
        self.bs = block_size
        self.chunk = max(1, prefill_chunk)
        # default budget: every slot decodes + one full prefill chunk rides
        self.budget = token_budget or (n_slots + self.chunk)
        self.n_slots = n_slots
        self.max_queue = max_queue         # waiting-queue bound; None = ∞
        self.waiting: deque[Request] = deque()
        self.admit_seq = 0                 # monotonic admission stamp
        self.admitted = 0
        self.preemptions = 0
        self.rejected = 0
        self.expired = 0                   # deadline failures (queued+in-flight)

    @property
    def queue_free(self) -> int | None:
        """Remaining waiting-queue capacity (None = unbounded)."""
        if self.max_queue is None:
            return None
        return max(0, self.max_queue - len(self.waiting))

    def submit(self, req: Request) -> bool:
        """Enqueue; False when the bounded queue is full (backpressure --
        the caller decides whether to raise QueueFull or block)."""
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            return False
        self.waiting.append(req)
        return True

    def requeue(self, req: Request) -> None:
        """Preempted request: back to the FRONT (it keeps its FCFS rank;
        exempt from the queue bound -- it already held a seat)."""
        self.waiting.appendleft(req)
        self.preemptions += 1

    def expire(self, now: float) -> list[Request]:
        """Remove and return every waiting request whose deadline has
        passed -- failing them BEFORE they waste prefill budget.

        Mutates `waiting` IN PLACE (one deque.remove per victim), never
        replacing the deque object: AsyncServingEngine.submit() appends to
        this deque from the caller thread while the tick thread expires,
        and a rebuilt-deque swap would silently drop any append that
        landed on the old object mid-rebuild (the handle would then never
        reach a terminal state)."""
        dead = [r for r in self.waiting
                if r.deadline is not None and now > r.deadline]
        for r in dead:
            try:
                self.waiting.remove(r)
            except ValueError:          # already popped by a racer
                pass
        self.expired += len(dead)
        return dead

    # -- admission ---------------------------------------------------------
    def admission_cost(self, req: Request, reused_tokens: int = 0) -> int:
        """Blocks the pool must supply to run `req`'s remaining prefill,
        plus one block of decode margin."""
        total = blocks_for(len(req.feed), self.bs)
        return total - reused_tokens // self.bs + 1

    def can_admit(self, req: Request, pool: BlockPool | None) -> bool:
        if pool is None:
            return True                    # recurrent-only models: slots gate
        return self.admission_cost(req) <= pool.available

    def next_admission(self, pool: BlockPool | None) -> Request | None:
        """Pop the head request if the pool can cover it (FCFS: the head
        blocks the queue rather than letting later requests jump it)."""
        if not self.waiting:
            return None
        if not self.can_admit(self.waiting[0], pool):
            return None
        self.admit_seq += 1
        self.admitted += 1
        return self.waiting.popleft()

    # -- per-tick token planning -------------------------------------------
    def plan(self, slots: list[dict | None]) -> list[int]:
        """Tokens each slot feeds this tick (0 = idle or budget-starved)."""
        n_tok = [0] * len(slots)
        budget = self.budget
        decoding = [(s["admit_seq"], i) for i, s in enumerate(slots)
                    if s is not None and s["fed"] >= len(s["seq"])]
        prefilling = [(s["admit_seq"], i) for i, s in enumerate(slots)
                      if s is not None and s["fed"] < len(s["seq"])]
        for _, i in sorted(decoding):
            if budget <= 0:
                break
            n_tok[i] = 1
            budget -= 1
        for _, i in sorted(prefilling):
            if budget <= 0:
                break
            s = slots[i]
            t = min(self.chunk, len(s["seq"]) - s["fed"], budget)
            n_tok[i] = t
            budget -= t
        return n_tok

    def pick_victim(self, slots: list[dict | None],
                    protect: set[int] = frozenset()) -> int | None:
        """Slot to preempt: the newest admission not in `protect`."""
        best = None
        for i, s in enumerate(slots):
            if s is None or i in protect:
                continue
            if best is None or s["admit_seq"] > slots[best]["admit_seq"]:
                best = i
        return best

    def stats(self) -> dict:
        return {"waiting": len(self.waiting), "admitted": self.admitted,
                "preemptions": self.preemptions, "rejected": self.rejected,
                "expired": self.expired, "max_queue": self.max_queue,
                "token_budget": self.budget}
