"""The one traffic generator: every cell's inputs come from the `traffic`
parameters of its workload file and from `--seed`.

Lengths and inter-arrival gaps are drawn as fixed quantiles of the stated
distribution, (i + 0.5) / n for i < n, in an order that the seed shuffles:
every seed sends the same set of lengths and gaps, so a seed changes the
order and the token ids and not the amount of work (the closed loop's
sessions: see `Sessions`).  Token ids are drawn uniformly from the
vocabulary.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np

_NORMAL = NormalDist()


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), *stream])


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n fixed quantiles of a length distribution: {"dist": "lognormal",
    "median", "sigma", "min", "max"} (clipped), {"dist": "uniform", "min",
    "max"} (whole numbers, both ends included) or {"dist": "geometric",
    "mean", "max"} (1, 2, ... with P(k) = p (1 - p)^(k - 1), p = 1 / mean,
    clipped)."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([_NORMAL.inv_cdf(x) for x in u])
        v = np.clip(np.rint(spec["median"] * np.exp(spec["sigma"] * z)), spec["min"], spec["max"])
    elif spec["dist"] == "uniform":
        v = spec["min"] + np.floor(u * (spec["max"] - spec["min"] + 1))
    elif spec["dist"] == "geometric":
        v = np.clip(np.ceil(np.log1p(-u) / math.log1p(-1.0 / spec["mean"])), 1, spec["max"])
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return v.astype(np.int64)


def shuffled(values: np.ndarray, g: np.random.Generator) -> np.ndarray:
    return values[g.permutation(len(values))]


def tokens(g: np.random.Generator, n: int, vocab: int) -> list[int]:
    return g.integers(0, vocab, n).tolist()


# ---------------------------------------------------------------------------
# serving: requests
# ---------------------------------------------------------------------------

@dataclass
class Request:
    prompt: list[int]
    max_new: int
    due: float = 0.0               # seconds after the window opens (open loop)
    user: int = -1                 # closed loop: the user that sent it


def open_loop(traffic: dict, seed: int, seconds: float, extra_s: float,
              vocab: int) -> list[Request]:
    """Poisson arrivals at `rate_per_s` over the window and `extra_s`
    after it (the drain keeps the load on), each block of gaps the fixed
    exponential quantiles for its span, shuffled; prompt and output
    lengths per `prompt` and `output`."""
    rate = traffic["rate_per_s"]
    out: list[Request] = []
    t = 0.0
    for block, span in enumerate((seconds, extra_s)):
        n = max(1, round(rate * span))
        g = rng(seed, 1, block)
        u = (np.arange(n) + 0.5) / n
        gaps = shuffled(-np.log1p(-u) / rate, g)
        plen = shuffled(quantiles(traffic["prompt"], n), g)
        olen = shuffled(quantiles(traffic["output"], n), g)
        for i in range(n):
            t += float(gaps[i])
            out.append(Request(tokens(g, int(plen[i]), vocab), int(olen[i]), due=t))
    return out


@dataclass
class Sessions:
    """A closed loop of `users` users in multi-turn sessions that open with
    one shared system prompt.  A turn sends the session's history (the
    system prompt, then each earlier turn's message and reply) plus a new
    message, and waits for the reply.  A session lasts its drawn number of
    `turns`, or ends sooner where the next turn would not fit in `max_len`
    positions; the user then opens a new one.

    Every seed sends the same work: `users` scripts, each a sequence of
    message, reply and session lengths, are drawn once from fixed pools of
    quantiles (sized to what a window uses: `window_turns` turns a user,
    sessions of the mean length) shuffled by `script_seed`, a constant of
    the workload.  The seed deals the scripts out to the users, and draws
    the system prompt and every message's token ids (a user's n-th turn
    from the stream (seed, user, n)), so a seed gives the same inputs
    whatever the timing.  A closed loop's window holds only a few turns a
    user, so scripts drawn anew for each seed would change the work a
    window does by some per cent."""
    traffic: dict
    seed: int
    vocab: int
    max_len: int
    system: list[int] = field(init=False)
    history: dict[int, list[int]] = field(init=False)
    sent: dict[int, int] = field(init=False)       # turns a user has sent
    left: dict[int, int] = field(init=False)       # turns left in its session
    opened: dict[int, int] = field(init=False)     # sessions a user has opened

    def __post_init__(self):
        t = self.traffic
        users = t["users"]
        n = users * t["window_turns"]
        self.system = tokens(rng(self.seed, 2), t["system_prompt"], self.vocab)
        g = rng(t.get("script_seed", 0), 5)
        self._msg = shuffled(quantiles(t["message"], n), g)
        self._out = shuffled(quantiles(t["output"], n), g)
        self._turns = shuffled(quantiles(t["turns"], users * math.ceil(
            t["window_turns"] / t["turns"]["mean"])), g)
        self.script = {u: int(s) for u, s in enumerate(rng(self.seed, 4).permutation(users))}
        self.history = {u: [] for u in range(users)}
        self.sent = {u: 0 for u in range(users)}
        self.left = {u: 0 for u in range(users)}
        self.opened = {u: 0 for u in range(users)}

    def _open(self, user: int) -> None:
        j = self.opened[user]
        self.opened[user] = j + 1
        self.history[user] = list(self.system)
        k = self.script[user] + j * self.traffic["users"]
        self.left[user] = int(self._turns[k % len(self._turns)])

    def next(self, user: int) -> Request:
        n = self.sent[user]
        i = (self.script[user] + n * self.traffic["users"]) % len(self._msg)
        msg = tokens(rng(self.seed, 3, user, n), int(self._msg[i]), self.vocab)
        out = int(self._out[i])
        if self.left[user] == 0 or len(self.history[user]) + len(msg) + out >= self.max_len:
            self._open(user)
        self.left[user] -= 1
        self.sent[user] = n + 1
        return Request(self.history[user] + msg, out, user=user)

    def replied(self, req: Request, reply: list[int]) -> None:
        self.history[req.user] = req.prompt + list(reply)


# ---------------------------------------------------------------------------
# the NeRF app: encoded sample points
# ---------------------------------------------------------------------------

def encode(torch, x, freqs: int):
    """NeRF's positional encoding gamma(p): sin and cos of 2^k * pi * p for
    k < freqs, for each coordinate of x (..., 3) -> (..., 6 * freqs)."""
    scales = (2.0 ** torch.arange(freqs, device=x.device, dtype=torch.float32)) * math.pi
    ang = (x[..., None, :] * scales[:, None]).flatten(-2)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def nerf_batches(torch, traffic: dict, config: dict, seed: int, device) -> list[dict]:
    """`batches` batches of `points` sample points: positions uniform in
    the unit cube [-1, 1]^3, view directions uniform on the sphere, each
    encoded as the configuration states, made on `device` from the seed in
    the configuration's dtype."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    dtype = getattr(torch, config["dtype"])
    out = []
    for _ in range(traffic["batches"]):
        n = traffic["points"]
        pos = torch.rand((n, 3), generator=gen, device=device) * 2 - 1
        d = torch.randn((n, 3), generator=gen, device=device)
        d = d / d.norm(dim=-1, keepdim=True)
        out.append({"pts": encode(torch, pos, config["pos_freqs"]).to(dtype),
                    "view": encode(torch, d, config["view_freqs"]).to(dtype)})
    return out
