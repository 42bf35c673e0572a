"""Config-zoo bridge: every `repro_torch.configs` architecture as a
traceable PyTorch function, so the capture front-end
(`repro_torch.compile(fn, example_inputs)`) turns each config into a
workload -- the counterpart of `repro/models/zoo.py`.

    from repro_torch.models import zoo
    zf = zoo.build("gemma3-1b", batch=2, seq=16, device="cpu")
    app = repro_torch.compile(zf.fn, zf.example_inputs, mode="kitsune")
    torch.testing.assert_close(app(*zf.example_inputs),
                               zf.fn(*zf.example_inputs))

The built function closes over initialised params (captured consts of the
traced graph) and takes the batch tensors positionally.  `phase="grad"`
builds the training function (gradients of the next-token loss with
respect to all params, through `torch.autograd.grad`).

Attention is routed through the atomic `models.atoms.attention_atom`
while the function runs (by default for the forward phase), so the
importer emits one "attention" node per attention site instead of the
chunked online softmax's einsums -- the granularity the paper's pattern
library expects.  Weights come from the model's own `init` with `seed`;
`params=` and `inputs=` take others (the tests carry the reference's
weights and inputs across with `params_from_numpy`).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch

from ..configs import ARCHS, get_config
from ..configs.base import ArchConfig
from ..train.step import value_and_grad
from . import atoms, get_model
from .lm import DTYPES


@dataclass(frozen=True)
class ZooFunction:
    """A traceable positional-args callable built from an ArchConfig."""
    name: str
    fn: Callable                 # fn(*example_inputs) -> outputs
    example_inputs: tuple
    cfg: ArchConfig
    phase: str = "forward"
    params: dict | None = None   # the weights fn closes over

    def reference(self, *args):
        """Run the function untraced (the differential tests' ground truth)."""
        return self.fn(*(args or self.example_inputs))


def names() -> list[str]:
    return sorted(ARCHS)


def example_inputs(cfg: ArchConfig, *, batch: int, seq: int, seed: int = 0,
                   device="cuda") -> tuple:
    """(tokens[, patch_embeds | frame_embeds]) for `cfg`, drawn from
    `seed`: vlm takes seq - vision_tokens text tokens and the patch
    embeddings, encdec seq decoder tokens and seq encoder frames."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dtype = DTYPES[cfg.dtype]
    n_txt = max(seq - cfg.vision_tokens, 1) if cfg.family == "vlm" else seq
    out = [torch.randint(0, cfg.vocab, (batch, n_txt), generator=gen, device=device)]
    if cfg.family == "vlm":
        out.append(torch.randn((batch, cfg.vision_tokens, cfg.d_model), generator=gen,
                               device=device).to(dtype))
    if cfg.family == "encdec":
        out.append(torch.randn((batch, seq, cfg.d_model), generator=gen,
                               device=device).to(dtype))
    return tuple(out)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The reference zoo's loss: mean log-sum-exp minus the label logit over
    the first S_txt positions, the labels the tokens shifted left and
    padded with 0."""
    logits = logits.float()
    labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    lg = logits[:, :labels.shape[1]]
    lse = torch.logsumexp(lg, dim=-1)
    ll = lg.gather(-1, labels[..., None].long())[..., 0]
    return (lse - ll).mean()


def build(cfg: ArchConfig | str, *, batch: int = 1, seq: int = 16,
          reduced: bool = True, seed: int = 0, phase: str = "forward",
          atomic_attention: bool | None = None, params: dict | None = None,
          inputs: tuple | None = None, device="cuda") -> ZooFunction:
    """A traceable function and example inputs for one architecture.

    reduced=True takes the config's CPU-sized variant (the differential
    tests' shape).  atomic_attention defaults to on for the forward and off
    for grad, as in the reference."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    r = cfg.reduced() if reduced else cfg
    if atomic_attention is None:
        atomic_attention = phase == "forward"
    model = get_model(r)
    if params is None:
        params = model.init(seed, device)
    if inputs is None:
        inputs = example_inputs(r, batch=batch, seq=seq, seed=seed, device=device)
    arg_names = ["tokens"] + (["patch_embeds"] if r.family == "vlm" else []) \
        + (["frame_embeds"] if r.family == "encdec" else [])

    def context():
        if atomic_attention:
            return atoms.patched(attention=atoms.atomic_chunked_attention)
        return contextlib.nullcontext()

    def forward(p, args):
        return model.forward(p, dict(zip(arg_names, args)))

    if phase == "forward":
        def fn(*args):
            with context():
                return forward(params, args)
    elif phase == "grad":
        def fn(*args):
            with context():
                _, grads = value_and_grad(
                    lambda p, a: next_token_loss(forward(p, a), a[0]), params, args)
                return grads
    else:
        raise ValueError(f"unknown phase {phase!r} (forward|grad)")
    fn.__name__ = f"zoo.{r.name}.{phase}"
    return ZooFunction(cfg.name, fn, tuple(inputs), r, phase, params)


def build_all(arch_names: list[str] | None = None, **kw) -> dict[str, ZooFunction]:
    return {n: build(n, **kw) for n in (arch_names or names())}
