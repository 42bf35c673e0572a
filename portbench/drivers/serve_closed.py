"""A closed loop of users in multi-turn sessions against the paged engine:
each user sends its next turn as soon as its reply is finished
(portbench/serving.py, traffic.py `Sessions`), timed from when it was
sent.

Set-up: the weights from the seed, the engine, the tick graphs captured
(as serve_open.py does), and the sessions' shared system prompt served
once, so that its pages sit in the prefix cache when the window opens.
"""
from __future__ import annotations

from portbench import serving
from portbench.drivers import serve_open


def warm(eng, feed) -> None:
    serve_open.warm(eng, feed)
    eng.submit(list(feed.sessions.system), max_new_tokens=1)
    serving.run_until_idle(eng)


def run(cell, **kw):
    return serving.serve_cell(cell, feed_of=serving.ClosedFeed, warm=warm, **kw)
