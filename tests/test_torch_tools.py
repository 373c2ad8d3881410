"""The port's viewer (procgen2_tpu_torch/tools/viewer.py): its key map
equals the reference's interactive_viewer.py:44-70 and the JAX
package's, key for key (the counterpart of tests/test_tools.py's
test_viewer_action_mapping). The viewer's window needs a display and is
not driven here."""
import itertools

import pytest
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class KS(dict):
    """pygame.key.get_pressed() as a dict: unpressed keys read False."""

    def __getitem__(self, k):
        return self.get(k, False)


def test_viewer_action_mapping():
    pygame = pytest.importorskip("pygame")
    from procgen2_tpu_torch.tools.viewer import compute_action

    K = pygame
    assert compute_action(KS(), K) == 4
    assert compute_action(KS({K.K_a: True}), K) == 1
    assert compute_action(KS({K.K_d: True}), K) == 7
    assert compute_action(KS({K.K_d: True, K.K_w: True}), K) == 8
    assert compute_action(KS({K.K_a: True, K.K_s: True}), K) == 0
    assert compute_action(KS({K.K_w: True}), K) == 5
    assert compute_action(KS({K.K_s: True}), K) == 3
    assert compute_action(KS({K.K_e: True}), K) == 9


def test_viewer_action_mapping_matches_jax():
    """Every subset of the keys a, d, w, s, e."""
    pygame = pytest.importorskip("pygame")
    from procgen2_tpu.tools.viewer import compute_action as jax_action
    from procgen2_tpu_torch.tools.viewer import compute_action

    keys = (pygame.K_a, pygame.K_d, pygame.K_w, pygame.K_s, pygame.K_e)
    for bits in itertools.product((False, True), repeat=len(keys)):
        ks = KS(zip(keys, bits))
        assert compute_action(ks, pygame) == jax_action(ks, pygame), bits
