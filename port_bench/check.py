"""What decides ``correct``: a sample of the requests that the window
completed, drawn from the seed with the longest among them, is worked out
again by the plain reference from the same inputs (text, speaker vector,
prenet masks, the vocoder's own inputs, weights made again from the
seed), and each waveform the served system returned is held against the
reference's:

- ``wave_rel_err``: the largest relative L2 distance of a sampled
  request's waveform from the reference's, ‖w − w_ref‖ / ‖w_ref‖;
- ``wave_rel_err_pooled``: the same over all the sampled waveforms
  together, √(Σ‖w − w_ref‖² / Σ‖w_ref‖²), steadier from seed to seed;
- ``wave_err_per_rounding``: ``wave_rel_err_pooled`` over the pooled
  distance by which the acoustic model's rounding to its stated type
  moves the reference (the reference with the acoustic model one step
  higher, against the reference): the served error in units of the
  stated type's own, which takes out how strongly a seed's random
  weights amplify any rounding over the decode;
- ``voc_rel_err``: the vocoder alone, the largest relative L2 distance
  of a served waveform from the reference vocoder's waveform of the mel
  that the served vocoder was given (kept in the window, see
  :class:`Keeper`), so that the acoustic model's rounding does not hide
  the vocoder's;
- ``len_diff``: the summed difference in samples of their lengths
  (the stop steps and the trim, worked out again), exactly 0;
- the vocoder part's own numbers (``parts/<vocoder>.py``: ``readings``).
  With WaveRNN, ``wavernn_step_miss``: the share of the sample steps of
  ``followed_requests`` requests whose mixture choice the noise does not
  pin at which the served sample departs by more than
  ``parts.wavernn.STEP_TOL`` from the sample the reference draws after
  the served stream's previous samples (the reference teacher-forced on
  the sample loop's raw folds, kept in the window, from the mel the
  served vocoder was given): the mixture choice, and so the mixture
  logits, judged step by step.

The part decides which requests the waveform numbers sample: with
WaveRNN only those whose mixture choice the noise pins
(``parts.wavernn.PIN``), since two free-running streams part for good at
a near tie of the choice.

The controls put the reference in the served system's place, one
precision step below what the configuration states: the whole model
(``control``), the acoustic model alone with the vocoder as stated
(``control_acoustic``), the vocoder alone with the acoustic model as
stated (``control_vocoder``).  Each is judged by :func:`passes`, the
rule that decides the served system's ``correct``, and has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

import inputs
import weights as W
from reference import tacotron2 as RT
from reference.g2p import phoneme_ids
from reference.precision import LOWER, Precision, no_tf32
from traffic.text import quantile_counts, sub_seed

HIGHER = {v: k for k, v in LOWER.items()}


def stated(cfg: dict, part) -> dict:
    """The precisions the configuration states: the acoustic model's
    ``infer_dtype`` and the vocoder's, as its part states it."""
    return {"acoustic": cfg["infer_dtype"], "vocoder": part.stated()}


def controls(prec: dict, part) -> dict:
    """The controls' precisions: every stage one step below (the
    vocoder's as its part says), and each stage alone one step below with
    the other as stated."""
    low = {"acoustic": LOWER[prec["acoustic"]], "vocoder": part.lower()}
    return {"control": low,
            "control_acoustic": dict(prec, acoustic=low["acoustic"]),
            "control_vocoder": dict(prec, vocoder=low["vocoder"])}


def passes(numbers: dict) -> bool:
    """The rule of ``correct``: every number at or under its limit."""
    return all(v <= lim for v, lim in numbers.values())


class Keeper:
    """Which requests the check may sample, decided from each request
    alone: each of the mix's longest phoneme count, and a share
    ``keep_share`` of the rest drawn from the request's seed.  The window
    keeps a device copy of the vocoder's input mel of each (for
    ``voc_rel_err``), and whatever the vocoder's part keeps (WaveRNN: the
    sample loop's raw folds of each unpinned one, for
    ``wavernn_step_miss``); the share keeps the copies to a few per cent
    of the cell's memory."""

    def __init__(self, traffic: dict, limits: dict):
        self.share = float(limits.get("keep_share", 1.0))
        self.top = max(quantile_counts(traffic["phonemes"]))

    def wants(self, r) -> bool:
        if r is None:
            return False
        return (r.n_phonemes >= self.top
                or sub_seed(r.seed, "keep") % 10_000 < self.share * 10_000)


def sample(requests: list, keeper: Keeper, n: int, seed: int,
           pinned: bool | None = None) -> list:
    """The longest request the keeper wants and ``n − 1`` more it wants,
    drawn from the seed, of those the window completed (with ``pinned``,
    of those whose mixture choice is pinned, or not)."""
    ok = [r for r in requests if r.wav is not None and r.error is None
          and keeper.wants(r) and (pinned is None or r.pinned == pinned)]
    if not ok or n <= 0:
        return []
    longest = max(ok, key=lambda r: (r.n_phonemes, -r.idx))
    rest = [r for r in ok if r is not longest]
    rng = np.random.default_rng(sub_seed(seed, "check", pinned))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def request_call(r, calls: list) -> tuple:
    """(call, row) of request ``r`` among the recorded ``calls``."""
    for c in calls:
        for row, q in enumerate(c.requests):
            if q is r:
                return c, row
    raise RuntimeError(f"request {r.idx} is in no recorded call")


def request_masks(cfg: dict, r, calls: list, device) -> torch.Tensor:
    """(S, 2, P) masks of request ``r``: its row of its call's masks."""
    c, row = request_call(r, calls)
    if c.mask_seed is None:
        m = inputs.server_masks(cfg, c.rows).to(device)
    else:
        m = inputs.prenet_masks(cfg, c.mask_seed, c.rows, device)
    return m[:, :, row]


class Reference:
    """The plain reference over the sampled requests: ``reqs``, whose
    waveforms are compared, then ``followed``, which the vocoder's part
    follows by readings of its own; ``masks`` their (S, 2, P) prenet
    masks, ``calls`` the window's calls.  The acoustic model's mels at a
    precision, and the vocoder's waveforms (float64 arrays) from given
    mels at a precision (``part.waves``); each worked out once, and
    ``memo`` keeps what the part works out."""

    def __init__(self, cfg: dict, part, seed: int, reqs: list,
                 followed: list, masks: list, calls: list, device,
                 backend: str = "rules"):
        self.cfg, self.part, self.device = cfg, part, device
        self.reqs, self.n = reqs + followed, len(reqs)
        self.masks, self.calls = masks, calls
        with torch.no_grad():
            self.wts = W.all_weights(cfg, sub_seed(seed, "weights"), device)
        self.ids = [phoneme_ids(r.text, backend) for r in self.reqs]
        self.spk = torch.as_tensor(inputs.speaker_vector(cfg, seed),
                                   device=device)
        # the served vocoder's input mels (None: it was never given one)
        self._mels: dict = {"served": [None if r.mel is None else
                                       r.mel.float() for r in self.reqs]}
        self._waves: dict = {}
        self.memo: dict = {}

    def rows(self, which: str) -> slice:
        """The ``"compared"`` or the ``"followed"`` requests' rows."""
        return slice(0, self.n) if which == "compared" else slice(self.n, None)

    @torch.no_grad()
    @no_tf32()
    def mels(self, prec: str) -> list:
        """The acoustic model's (n_mel, frames) mels at ``prec``, or the
        served system's for ``"served"``, of every sampled request."""
        if prec not in self._mels:
            mels, frames = RT.synthesize_mels(
                Precision(prec), self.wts["tacotron"],
                W.model_params(self.cfg), self.ids,
                self.spk[None].expand(len(self.reqs), -1),
                torch.stack(self.masks, 2))
            self._mels[prec] = [mels[i, :, :f] for i, f in enumerate(frames)]
        return self._mels[prec]

    @torch.no_grad()
    @no_tf32()
    def waves(self, prec: str, mels: str) -> list:
        """The vocoder's waveforms at ``prec`` of the compared requests'
        mels ``self.mels(mels)``."""
        key = (prec, mels)
        if key not in self._waves:
            self._waves[key] = self.part.waves(self, prec, mels)
        return self._waves[key]


def compare(waves: list, refs: list) -> dict:
    rel, dlen, d2, r2 = 0.0, 0, 0.0, 0.0
    for w, ref in zip(waves, refs):
        w = np.asarray(w, np.float64)
        ref = np.asarray(ref, np.float64)
        dlen += abs(len(w) - len(ref))
        n = min(len(w), len(ref))
        d = float(np.sum((w[:n] - ref[:n]) ** 2))
        r = float(np.sum(ref[:n] ** 2))
        e = np.sqrt(d / max(r, 1e-300))
        rel = max(rel, float(e) if np.isfinite(e) else float("inf"))
        d2, r2 = d2 + d, r2 + r
    pooled = np.sqrt(d2 / max(r2, 1e-300))
    return {"wave_rel_err": rel,
            "wave_rel_err_pooled": float(pooled) if np.isfinite(pooled)
            else float("inf"),
            "len_diff": float(dlen)}


def judge(cfg, traffic, limits, seed, requests, calls, device, part, *,
          backend: str = "rules", log=print, control: bool = False) -> tuple:
    """(readings, controls): name → value for the sampled requests, every
    number the check works out; with ``control``, each control's name →
    its readings in the served system's place.  ``part``: the mix's
    vocoder's.  An empty sample reads ``sampled_requests`` 0, which
    fails."""
    keeper = Keeper(traffic, limits)

    def draw(n: int, pinned: bool | None = None) -> list:
        return sample(requests, keeper, n, seed, pinned)

    reqs, followed = part.sample(draw, limits)
    if not reqs:
        return {"sampled_requests": 0.0}, {}
    masks = [request_masks(cfg, r, calls, device) for r in reqs + followed]
    prec = stated(cfg, part)
    ref = Reference(cfg, part, seed, reqs, followed, masks, calls, device,
                    backend)
    refs = ref.waves(prec["vocoder"], prec["acoustic"])
    log(f"check: {len(reqs)} requests ({', '.join(str(r.idx) for r in reqs)}"
        f"), phonemes {[r.n_phonemes for r in reqs]}, reference waveform rms "
        f"{[round(float(np.sqrt(np.mean(x ** 2))), 4) for x in refs]}; "
        f"followed step by step: {[r.idx for r in followed]}")
    unit = None
    if "wave_err_per_rounding" in limits:
        higher = HIGHER[prec["acoustic"]]
        unit = max(compare(ref.waves(prec["vocoder"], higher),
                           refs)["wave_rel_err_pooled"], 1e-300)

    def readings(waves: list, mels: str, vocoder: str | None) -> dict:
        """The numbers of ``waves``, which a vocoder made from the mels
        ``ref.mels(mels)``: the served one (``vocoder`` None) or the
        reference at ``vocoder``."""
        out = compare(waves, refs)
        out["voc_rel_err"] = (
            float("inf") if any(m is None for m in ref.mels(mels)) else
            compare(waves, ref.waves(prec["vocoder"], mels))["wave_rel_err"])
        if unit is not None:
            out["wave_err_per_rounding"] = out["wave_rel_err_pooled"] / unit
        with torch.no_grad(), no_tf32():
            out.update(part.readings(ref, limits, prec["vocoder"], mels,
                                     vocoder))
        return out

    got = readings([r.wav for r in reqs], "served", None)
    if not control:
        return got, {}
    ctl = {}
    for name, p in controls(prec, part).items():
        ctl[name] = readings(ref.waves(p["vocoder"], p["acoustic"]),
                             p["acoustic"], p["vocoder"])
    return got, ctl


def limited(readings: dict, limits: dict) -> dict:
    """name → (value, limit) for the readings that have a limit (an empty
    sample's ``sampled_requests`` has -1)."""
    lim = dict(limits, sampled_requests=-1.0)
    return {k: (v, float(lim[k])) for k, v in readings.items() if k in lim}
