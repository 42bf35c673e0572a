"""`python -m repro_torch.launch.serve --compile-mode {bsp,vertical,kitsune}`
(the reference's `src/repro/launch/serve.py` flag, passed into
`ServeConfig.compile_mode`): the launcher's tick traced and run on each
compiler mode's executor gives the eager launcher's tokens, for the paged
and the legacy engine, on reduced gemma3-1b on the CPU."""
import pytest

from repro_torch.launch import serve as launch_serve

ARGV = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--requests", "3",
        "--batch", "2", "--max-len", "12", "--num-blocks", "8"]
_EAGER: dict = {}


def _serve(engine: str, *extra: str) -> dict:
    return launch_serve.main(ARGV + ["--engine", engine, *extra])


def _eager(engine: str) -> dict:
    if engine not in _EAGER:
        _EAGER[engine] = _serve(engine)
    return _EAGER[engine]


@pytest.mark.parametrize("mode", ["bsp", "vertical", "kitsune"])
@pytest.mark.parametrize("engine", ["paged", "legacy"])
def test_compile_mode_serves_the_eager_tokens(engine, mode, capsys):
    want = _eager(engine)
    assert sorted(want) == [0, 1, 2] and all(want.values())
    assert _serve(engine, "--compile-mode", mode) == want
    assert "served 3/3 requests" in capsys.readouterr().out


def test_compile_mode_refuses_an_unknown_mode():
    with pytest.raises(SystemExit):
        _serve("paged", "--compile-mode", "eager")
