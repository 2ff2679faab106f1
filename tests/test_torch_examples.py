"""The port's inverse-rendering examples
(``tinyraytracing_tpu_torch/examples/``) against the JAX package's
(``examples/inverse_rendering.py``, ``examples/inverse_demo.py``).

Each side of each example runs its first EXAMPLE_STEPS steps at
EXAMPLE_SIZE x EXAMPLE_SIZE in an aligned process of its own
(``tests/torch_aligned_render.py``, ``example:<example>:<side>``; FMA
contraction off, the JAX trace kernel in interpret mode, XLA's
transcendentals in the port), the four side by side: the JAX side makes
the JAX example's own calls (``jax.value_and_grad`` of
``diff.inverse.render_loss`` with plain steps; ``render_loss_fast`` with
``optax.adam``), the port side calls the port example's
``recover_albedo``. Tolerances: the first loss within 1e-6 relative (the
same forward, aligned), the second within 1e-5 relative (one update from
gradients that agree to float rounding), and the albedo errors within
1e-5 of each other.
"""

import numpy as np
import pytest
import torch

from tests.torch_aligned_render import EXAMPLE_STEPS, run_processes
from tinyraytracing_tpu_torch.examples import inverse_demo, inverse_rendering

EXAMPLES = ("rendering", "demo")


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    return run_processes(str(tmp_path_factory.mktemp("aligned_examples")),
                         [f"example:{e}:{side}" for e in EXAMPLES
                          for side in ("jax", "port")])


@pytest.mark.parametrize("example", EXAMPLES)
def test_first_losses_match_jax(aligned, example):
    want, got = aligned[f"example-{example}-jax"], aligned[f"example-{example}-port"]
    assert got.shape == want.shape == (EXAMPLE_STEPS, 2)
    assert np.isfinite(got).all() and (got[:, 0] > 0).all()
    assert abs(got[0, 0] - want[0, 0]) <= 1e-6 * want[0, 0]
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("example", EXAMPLES)
def test_loss_and_albedo_error_fall(aligned, example):
    loss, err = aligned[f"example-{example}-port"].T
    assert (np.diff(loss) < 0).all() and (np.diff(err) < 0).all()


def test_inverse_rendering_writes_its_outputs(tmp_path, capsys):
    out = tmp_path / "ir"
    assert inverse_rendering.main(["--steps", "1", "--size", "8", "--spp", "1",
                                   "--device", "cpu", "--out", str(out)]) == 0
    for name in ("target.png", "initial.png", "recovered.png", "log.json"):
        assert (out / name).is_file(), name
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("mod,argv", [
    (inverse_rendering, ["--steps", "1", "--size", "8"]),
    (inverse_demo, ["1", "8"]),
])
def test_examples_need_a_card_unless_cpu_is_asked(mod, argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(argv)
