"""What decides ``correct``: a sample of the requests that the window
completed, drawn from the seed with the longest among them, is worked out
again by the plain reference from the same inputs (text, speaker vector,
prenet masks, WaveRNN noise, weights made again from the seed), and each
waveform the served system returned is held against the reference's:

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
- ``wavernn_step_miss``: with WaveRNN, the share of the sample steps of
  ``followed_requests`` requests whose mixture choice the noise does not
  pin at which the served sample departs by more than ``STEP_TOL`` from
  the sample the reference draws after the served stream's previous
  samples (the reference teacher-forced on the sample loop's raw folds,
  kept in the window, from the mel the served vocoder was given): the
  mixture choice, and so the mixture logits, judged step by step;
- ``len_diff``: the summed difference in samples of their lengths
  (the stop steps and the trim, worked out again), exactly 0.

With WaveRNN the waveform numbers sample only requests whose mixture
choice the noise pins (see ``inputs.PIN``): two free-running streams
part for good at a near tie of the choice.

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
from reference import hifigan as RH
from reference import tacotron2 as RT
from reference import wavernn as RW
from reference.g2p import phoneme_ids
from reference.precision import Precision, no_tf32
from traffic.text import quantile_counts, sub_seed

LOWER = {"float32": "bfloat16", "bfloat16": "float8"}
# a sample step departs where the served sample and the reference's draw
# differ by more than this: ~10 x their rounding, below the distance
# between two mixture components' samples
STEP_TOL = 0.02
HIGHER = {v: k for k, v in LOWER.items()}


def stated(cfg: dict, vocoder: str) -> dict:
    """The precisions the configuration states: the acoustic model's
    ``infer_dtype``, the sample loop's ``gen_dtype``, HiFi-GAN's
    float32."""
    voc = {"hifigan": "float32"}
    if "wavernn" in cfg["vocoders"]:
        voc["wavernn"] = cfg["vocoders"]["wavernn"]["gen_dtype"]
    return {"acoustic": cfg["infer_dtype"], "vocoder": voc[vocoder]}


def controls(prec: dict) -> dict:
    """The controls' precisions: every stage one step below, and each
    stage alone one step below with the other as stated."""
    return {"control": {k: LOWER[v] for k, v in prec.items()},
            "control_acoustic": dict(prec, acoustic=LOWER[prec["acoustic"]]),
            "control_vocoder": dict(prec, vocoder=LOWER[prec["vocoder"]])}


def passes(numbers: dict) -> bool:
    """The rule of ``correct``: every number at or under its limit."""
    return all(v <= lim for v, lim in numbers.values())


class Keeper:
    """Which requests the check may sample, decided from each request
    alone: each of the mix's longest phoneme count, and a share
    ``keep_share`` of the rest drawn from the request's seed.  The window
    keeps a device copy of the vocoder's input mel of each (for
    ``voc_rel_err``), and with WaveRNN of the sample loop's raw folds of
    each unpinned one (for ``wavernn_step_miss``); the share keeps the
    copies to a few per cent of the cell's memory."""

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


def request_masks(cfg: dict, r, calls: list, device) -> torch.Tensor:
    """(S, 2, P) masks of request ``r``: its row of its call's masks."""
    for c in calls:
        for row, q in enumerate(c.requests):
            if q is r:
                if c.mask_seed is None:
                    m = inputs.server_masks(cfg, c.rows).to(device)
                else:
                    m = inputs.prenet_masks(cfg, c.mask_seed, c.rows, device)
                return m[:, :, row]
    raise RuntimeError(f"request {r.idx} is in no recorded call")


class Reference:
    """The plain reference over the sampled requests: ``reqs``, whose
    waveforms are compared, then ``followed``, whose sample streams are
    followed step by step (WaveRNN); ``masks`` their (S, 2, P) prenet
    masks.  The acoustic model's mels at a precision, and a vocoder's
    waveforms (float64 arrays) or raw folds from given mels at a
    precision; each worked out once."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, reqs: list,
                 followed: list, masks: list, device,
                 backend: str = "rules"):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.reqs, self.n = reqs + followed, len(reqs)
        self.masks = masks
        with torch.no_grad():
            self.wts = W.all_weights(cfg, sub_seed(seed, "weights"), device)
        self.ids = [phoneme_ids(r.text, backend) for r in self.reqs]
        self.spk = torch.as_tensor(inputs.speaker_vector(cfg, seed),
                                   device=device)
        # the served vocoder's input mels (None: it was never given one)
        self._mels: dict = {"served": [None if r.mel is None else
                                       r.mel.float() for r in self.reqs]}
        self._waves: dict = {}
        self._raw: dict = {}
        if "wavernn" in cfg["vocoders"]:
            self.v = dict(cfg["vocoders"]["wavernn"],
                          upsample_factors=list(
                              cfg["vocoders"]["wavernn"]["upsample_factors"]))

    def _rows(self, which: str) -> slice:
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
            m = self.mels(mels)[: self.n]
            if self.traffic["vocoder"] == "hifigan":
                h = self.cfg["vocoders"]["hifigan"]
                self._waves[key] = [
                    RH.generate(Precision(prec), self.wts["hifigan"], h,
                                x[None])[0].double().cpu().numpy() for x in m]
            else:
                samples, n_folds = self.raw(prec, mels, "compared")
                self._waves[key] = RW.unfold(self.v, samples, n_folds,
                                             [x.shape[-1] for x in m])
        return self._waves[key]

    def _noises(self, reqs: list, mels: list) -> list:
        hop = self.cfg["audio_params"]["hop_length"]
        bucket = -(-max(m.shape[-1] for m in mels) // 32) * 32
        _, n_pad = inputs.fold_rows(bucket, hop, self.v["target"],
                                    self.v["overlap"])
        L = self.v["target"] + 2 * self.v["overlap"]
        return [inputs.wavernn_noise(sub_seed(r.seed, "noise"), L, n_pad,
                                     self.device, pinned=r.pinned)
                for r in reqs]

    @torch.no_grad()
    @no_tf32()
    def raw(self, prec: str, mels: str, which: str) -> tuple:
        """WaveRNN's raw folds (B, n_pad, L) at ``prec`` from the mels
        ``self.mels(mels)`` of the ``"compared"`` or ``"followed"``
        requests, and the real fold count."""
        key = (prec, mels, which)
        if key not in self._raw:
            rows = self._rows(which)
            m = self.mels(mels)[rows]
            self._raw[key] = RW.raw_samples(
                Precision(prec), self.wts["wavernn"], self.v, m,
                self._noises(self.reqs[rows], m))
        return self._raw[key]

    @torch.no_grad()
    @no_tf32()
    def steps_missed(self, stream, prec: str, mels: str) -> float:
        """The share of the followed requests' sample steps (real folds)
        at which ``stream`` (B, n_pad, L) departs by more than
        ``STEP_TOL`` (or is not a number) from the sample the reference
        at ``prec`` draws, from the mels ``self.mels(mels)``, after the
        stream's previous samples."""
        rows = self._rows("followed")
        m = self.mels(mels)[rows]
        drawn, n_folds = RW.raw_samples(
            Precision(prec), self.wts["wavernn"], self.v, m,
            self._noises(self.reqs[rows], m), forced=stream)
        d = (drawn[:, :n_folds] - stream[:, :n_folds].float()).abs()
        return float((~(d <= STEP_TOL)).float().mean())


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


def judge(cfg, traffic, limits, seed, requests, calls, device, *,
          backend: str = "rules", log=print, control: bool = False) -> tuple:
    """(readings, controls): name → value for the sampled requests, every
    number the check works out; with ``control``, each control's name →
    its readings in the served system's place.  An empty sample reads
    ``sampled_requests`` 0, which fails."""
    keeper = Keeper(traffic, limits)
    n = int(limits["requests"])
    followed = []
    if traffic["vocoder"] == "wavernn":
        reqs = sample(requests, keeper, n, seed, pinned=True)
        followed = sample(requests, keeper,
                          int(limits.get("followed_requests", 0)), seed,
                          pinned=False)
    else:
        reqs = sample(requests, keeper, n, seed)
    if not reqs:
        return {"sampled_requests": 0.0}, {}
    masks = [request_masks(cfg, r, calls, device) for r in reqs + followed]
    prec = stated(cfg, traffic["vocoder"])
    ref = Reference(cfg, traffic, seed, reqs, followed, masks, device,
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

    def readings(waves: list, mels: str, stream) -> dict:
        """The numbers of ``waves``, which a vocoder made from the mels
        ``ref.mels(mels)``, and of the followed requests' raw folds
        ``stream`` (None: missing)."""
        out = compare(waves, refs)
        out["voc_rel_err"] = (
            float("inf") if any(m is None for m in ref.mels(mels)) else
            compare(waves, ref.waves(prec["vocoder"], mels))["wave_rel_err"])
        if unit is not None:
            out["wave_err_per_rounding"] = out["wave_rel_err_pooled"] / unit
        if "followed_requests" in limits:
            out["wavernn_step_miss"] = (
                float("inf") if stream is None or not followed else
                ref.steps_missed(stream, prec["vocoder"], mels))
        return out

    served = (None if any(r.folds is None for r in followed) or not followed
              else torch.stack([r.folds for r in followed]))
    got = readings([r.wav for r in reqs], "served", served)
    if not control:
        return got, {}
    ctl = {}
    for name, p in controls(prec).items():
        stream = (ref.raw(p["vocoder"], p["acoustic"], "followed")[0]
                  if followed else None)
        ctl[name] = readings(ref.waves(p["vocoder"], p["acoustic"]),
                             p["acoustic"], stream)
    return got, ctl


def limited(readings: dict, limits: dict) -> dict:
    """name → (value, limit) for the readings that have a limit (an empty
    sample's ``sampled_requests`` has -1)."""
    lim = dict(limits, sampled_requests=-1.0)
    return {k: (v, float(lim[k])) for k, v in readings.items() if k in lim}
