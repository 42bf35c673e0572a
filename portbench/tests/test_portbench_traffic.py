"""The generator: the same seed gives the same inputs; another seed the
same lengths and gaps in another order."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import bench, traffic

CHAT = bench.load_json(bench.HERE / "workloads" / "phi3.chat.json")["traffic"]
MULTI = bench.load_json(bench.HERE / "workloads" / "phi3.multiturn.json")


def test_open_loop_same_seed_same_requests():
    a = traffic.open_loop(CHAT, 2**40 + 3, 30, 10, 32064)
    b = traffic.open_loop(CHAT, 2**40 + 3, 30, 10, 32064)
    assert [(r.prompt, r.max_new, r.due) for r in a] == [(r.prompt, r.max_new, r.due) for r in b]


def test_open_loop_seeds_share_lengths_and_gaps():
    a = traffic.open_loop(CHAT, 1, 30, 10, 32064)
    b = traffic.open_loop(CHAT, 2, 30, 10, 32064)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    n = round(CHAT["rate_per_s"] * 30)
    assert a[n - 1].due == pytest.approx(b[n - 1].due)   # the window's last arrival
    assert [r.prompt for r in a] != [r.prompt for r in b]
    lens = np.array([len(r.prompt) for r in a])
    assert lens.min() >= 4 and lens.max() <= 1024 and 90 <= np.median(lens) <= 115


def test_sessions_history_and_restart():
    t = dict(MULTI["traffic"], users=2, turns={"dist": "geometric", "mean": 2.0, "max": 2})
    ss = traffic.Sessions(t, 9, 100, 2048)
    sys_n = t["system_prompt"]
    r1 = ss.next(0)
    assert r1.prompt[:sys_n] == ss.system and 4 <= len(r1.prompt) - sys_n <= 512
    turns = ss.left[0] + 1
    ss.replied(r1, [1, 2, 3])
    r2 = ss.next(0)
    if turns == 2:                        # the session goes on: its history leads
        assert r2.prompt[:len(r1.prompt) + 3] == r1.prompt + [1, 2, 3]
    else:                                 # a new session
        assert r2.prompt[:sys_n] == ss.system and len(r2.prompt) <= sys_n + 512
    again = traffic.Sessions(t, 9, 100, 2048)
    assert again.next(0).prompt == r1.prompt


def test_sessions_fit_max_len():
    """Every turn, with its reply, fits in the engine's max_len, however
    long the session has run: a turn that would not fit opens a new one."""
    wl = MULTI
    t = wl["traffic"]
    ss = traffic.Sessions(t, 3, 32064, wl["serve"]["max_len"])
    turns = 6 * t["window_turns"]
    for u in range(t["users"]):
        for _ in range(turns):
            r = ss.next(u)
            assert len(r.prompt) + r.max_new < wl["serve"]["max_len"]
            assert r.prompt[:len(ss.system)] == ss.system
            ss.replied(r, [7] * r.max_new)
    # a session in two turns by its drawn length, and sooner where max_len ends it
    opened = sum(ss.opened.values()) / (turns * t["users"])
    assert 0.5 <= opened <= 0.7


@pytest.mark.parametrize("name,key", [("phi3.chat", "prompt"), ("phi3.chat", "output"),
                                      ("phi3.multiturn", "message"),
                                      ("phi3.multiturn", "output")])
def test_lengths_keep_the_published_mean(name, key):
    """Each length distribution's clipped quantiles average to the mean its
    source publishes (the workload file's `mean_published`), within 1 %."""
    spec = bench.load_json(bench.HERE / "workloads" / f"{name}.json")["traffic"][key]
    got = traffic.quantiles(spec, 4096).mean()
    assert got == pytest.approx(spec["mean_published"], rel=0.01)


def test_geometric_turns():
    q = traffic.quantiles({"dist": "geometric", "mean": 2.0, "max": 8}, 4096)
    assert q.min() == 1 and q.max() == 8 and q.mean() == pytest.approx(2.0, rel=0.01)


def test_quantiles():
    q = traffic.quantiles({"dist": "uniform", "min": 32, "max": 64}, 33)
    assert sorted(q.tolist()) == list(range(32, 65))


def test_sessions_seeds_share_lengths():
    """Two seeds send the same set of message and reply lengths over the
    turns a window holds (`window_turns` a user)."""
    t = MULTI["traffic"]
    got = []
    for seed in (1, 2):
        ss = traffic.Sessions(t, seed, 32064, MULTI["serve"]["max_len"])
        reqs = [ss.next(u) for _ in range(t["window_turns"]) for u in range(t["users"])]
        got.append(sorted(r.max_new for r in reqs))
    assert got[0] == got[1]


def test_sessions_seeds_deal_the_same_scripts():
    """Every seed sends the same scripts (each user's sequence of message,
    reply and session lengths), dealt out to the users in another order,
    with other token ids: a window's work does not depend on the seed."""
    t = MULTI["traffic"]
    scripts, prompts, owners = [], [], []
    for seed in (2**40 + 1, 2**40 + 2):
        ss = traffic.Sessions(t, seed, 32064, MULTI["serve"]["max_len"])
        per_user = {}
        for u in range(t["users"]):
            turns = []
            for _ in range(2 * t["window_turns"]):
                r = ss.next(u)
                turns.append((len(r.prompt), r.max_new, ss.opened[u]))
                ss.replied(r, [5] * r.max_new)
            per_user[u] = turns
        scripts.append(sorted(per_user.values()))
        owners.append([per_user[u] for u in range(t["users"])])
        prompts.append(ss.system)
    assert scripts[0] == scripts[1]
    assert owners[0] != owners[1] and prompts[0] != prompts[1]
