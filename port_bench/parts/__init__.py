"""The vocoders, one part each: ``parts/<name>.py`` holds everything the
harness knows of the vocoder ``<name>``, the key of a configuration's
``vocoders`` and the value of a mix's ``vocoder``.  The harness reaches a
vocoder only through its part, so a configuration brings a new vocoder as
new files: its part, its plain reference under ``reference/``, its work
counts under ``work/``, its configuration, mix and checks, and metric
readers.

A part module defines ``Part``, a subclass of :class:`Part` below, and
the harness makes one for each vocoder a configuration lists, at set-up
(:func:`of`).  Its methods are the eight things the harness asks of a
vocoder; the defaults fit a vocoder that has no weights, takes no inputs
of its own and keeps nothing in the window.
"""

from __future__ import annotations

import importlib
import os

import weights as W
from reference.precision import LOWER

HERE = os.path.dirname(os.path.abspath(__file__))


class Part:
    name = ""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.block = cfg["vocoders"][self.name]

    def weight_spec(self) -> dict:
        """1. Its weights: name → (shape, range or constant) for
        ``weights.make``, under the published checkpoint's keys; empty
        where it has none."""
        return {}

    def build(self, sd: dict | None, device):
        """2. The served vocoder built from the ``state_dict`` ``sd`` as a
        deployment builds it (the module made on the device,
        ``load_state_dict(strict=True)``, then the wrapper that
        ``AdaptiveTTS.attach_vocoder`` takes), or None where the port
        serves it without attaching one."""
        return None

    def stated(self) -> str:
        """3. The precision the configuration states for it, which the
        reference computes in and the controls step down from."""
        raise NotImplementedError

    def lower(self) -> str:
        """3b. The precision of its control: the nearest below the stated
        one."""
        return LOWER[self.stated()]

    def call_inputs(self, ctx, reqs: list) -> dict:
        """4. Keyword arguments of its own for one call of
        ``synthesize`` (one request) or ``synthesize_batch`` over
        ``reqs``, made from each request's seed on ``ctx.device``."""
        return {}

    def hook(self, ctx) -> None:
        """5. Wraps the served vocoder so that the window keeps, in each
        request's ``kept``, the copies the check needs (once, at set-up;
        the requests the check may sample are ``ctx.keeper.wants``, the
        call under way ``ctx.current``)."""

    def sample(self, draw, limits: dict) -> tuple:
        """6a. (compared, followed): the requests whose waveforms are
        compared and those the part follows by readings of its own.
        ``draw(n, pinned=None)`` draws ``n`` as ``check.sample`` does."""
        return draw(int(limits["requests"])), []

    def waves(self, ref, prec: str, mels: str) -> list:
        """6b. Its reference's float64 waveforms at ``prec`` of the
        compared requests' mels ``ref.mels(mels)`` (``ref``:
        ``check.Reference``, under no_grad and TF32 off)."""
        raise NotImplementedError

    def readings(self, ref, limits: dict, prec: str, mels: str,
                 control: str | None = None) -> dict:
        """6c. Numbers of its own: of the served system (``control``
        None) or of the reference at ``control`` in its place, against
        its reference at ``prec`` from the mels ``ref.mels(mels)``
        (under no_grad and TF32 off)."""
        return {}

    def seconds_at_peak(self, run, r) -> float:
        """7. The least time the chip needs for its operations on request
        ``r``'s mel, each type's operations over its peak
        (``work/peaks.py``)."""
        raise NotImplementedError

    def counters(self) -> dict:
        """8. The port's launch counters it owns, so far in the process."""
        return {}


def load(cfg: dict, name: str) -> Part:
    """The part of the vocoder ``name`` for configuration ``cfg``."""
    if not os.path.exists(os.path.join(HERE, f"{name}.py")):
        raise SystemExit(f"the configuration names the vocoder {name!r}, "
                         f"but there is no port_bench/parts/{name}.py")
    return importlib.import_module(f"parts.{name}").Part(cfg)


def of(cfg: dict) -> dict:
    """name → part of each vocoder the configuration lists, in the order
    their weights are drawn (``weights.vocoder_order``)."""
    return {n: load(cfg, n) for n in W.vocoder_order(cfg)}
