"""The port's preemption guard in a test process shared with the JAX
package's tests.

Every port trainer installs the process-wide
``msa_tts_tpu_torch.utils.preemption.PreemptionGuard.shared()`` on
SIGTERM.  The JAX package's guard chains the handler it replaces, so a
SIGTERM that one of its tests sends itself reaches the port's guard too
when that guard is still installed: its stop flag is set, the next port
trainer in the process stops before its first step, and a second such
notice escalates (restores the default disposition and re-raises), which
kills the test process.  ``torch_parity.fresh_port_guard`` (the
``port_guard`` fixture of every trainer test file) uninstalls the port's
guard after each test; these tests hold that repair.
"""

import argparse
import os
import signal
import subprocess
import sys

import pytest

from msa_tts_tpu.utils.preemption import PreemptionGuard as JaxGuard
from msa_tts_tpu_torch.config import save_params
from msa_tts_tpu_torch.trainers import reptile as TR
from msa_tts_tpu_torch.utils.preemption import PreemptionGuard
from torch_parity import (
    fresh_port_guard,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
    port_guard,  # noqa: F401  (taken by pytestmark)
    tiny_corpus,
    tiny_train_params,
)

pytestmark = pytest.mark.usefixtures("port_guard")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reptile_main(tmp_path, corpus):
    """``trainers.reptile.main`` on the tiny experiment: 2 epochs of one
    meta-batch of 2 speakers, sequential, so 4 global steps; returns the
    trainer."""
    p = tiny_train_params(corpus, str(tmp_path / "out"), "reptile",
                          meta_batch_size=2, n_inner_train=2,
                          n_inner_test=1, reptile_mode="sequential",
                          device="cpu", n_epochs=2,
                          metatest_epoch_interval=2,
                          optim_outer={"optimizer_type": "SGD",
                                       "lr": "1.0"})
    save_params(p, str(tmp_path / "params.yml"))
    ran = []

    class Kept(TR.Reptile):
        def run(self):
            ran.append(self)
            super().run()

    orig, TR.Reptile = TR.Reptile, Kept
    try:
        TR.main(argparse.Namespace(params_path=str(tmp_path)))
    finally:
        TR.Reptile = orig
    return ran[0]


def test_a_chained_sigterm_does_not_stop_the_next_trainer(tmp_path):
    """A real SIGTERM reaches the port's shared guard through a JAX guard
    installed on top of it (which chains it, as in ``test_preemption``);
    with the fixture's teardown in between, the next trainer still takes
    all of its 4 steps, and the process's SIGTERM disposition is back to
    what it was before the guard was installed.  The test's own SIGTERM
    stops at the port's guard: the disposition under it is the default
    for that part (a handler already installed in this test process, a
    JAX shared guard for one, must not hear it)."""
    before = signal.getsignal(signal.SIGTERM)
    corpus = tiny_corpus(str(tmp_path / "corpus"))
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        with fresh_port_guard():            # what the fixture does
            port = PreemptionGuard.shared()  # as a trainer installs it
            assert port.installed and not port.should_stop
            outer = JaxGuard().install()
            try:
                os.kill(os.getpid(), signal.SIGTERM)
            finally:
                outer.uninstall()
            assert outer.should_stop
            assert port.should_stop         # the notice reached the port
        assert PreemptionGuard._shared is None and not port.installed
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    finally:
        signal.signal(signal.SIGTERM, before)
    with fresh_port_guard():
        t = _reptile_main(tmp_path, corpus)
        assert t.step_global == 4
    assert signal.getsignal(signal.SIGTERM) is before


def test_the_order_that_killed_the_process_passes():
    """The port's MAML preemption tests, the JAX package's guard tests
    and the Reptile entry point, in that order in one pytest process:
    before the repair the JAX tests' SIGTERMs escalated through the
    port's guard, already set, and killed the process (rc 143)."""
    cmd = [sys.executable, "-m", "pytest", "-n", "0", "-p",
           "no:cacheprovider", "-q",
           "tests/test_torch_maml_checkpoint.py", "tests/test_preemption.py",
           "tests/test_torch_reptile.py",
           "-k", "preempted_run or guard or main_runs"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=env)
    tail = (p.stdout + p.stderr)[-3000:]
    assert p.returncode == 0, tail
    assert " passed" in p.stdout and "failed" not in p.stdout, tail
