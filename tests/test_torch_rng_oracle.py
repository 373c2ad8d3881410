"""The port's RNG oracle (procgen2_tpu_torch/tools/rng_oracle.py): the
tests of tests/test_rng_oracle.py on the port's copy, and the copy held
against the JAX package's, exactly: the raw and distribution streams,
the unordered_set iteration order and every reference layout, for seeds
0-19 of every game, mode and coinrun flag. The port builds its library
from native/rng_oracle.cpp; the JAX package loads native/librng_oracle.so,
so two builds of one source are held against each other."""
import shutil

import numpy as np
import pytest

from procgen2_tpu.tools import rng_oracle as J
from procgen2_tpu_torch.tools import rng_oracle as O
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = [
    pytest.mark.skipif(
        shutil.which("g++") is None, reason="no C++ toolchain"
    ),
    pytest.mark.usefixtures("one_torch_thread"),
]

SEEDS = range(20)


def test_mt19937_reference_values():
    # mt19937(5489) 10000th raw output is the canonical 4123659995
    r = O.Mt19937(5489)
    v = 0
    for _ in range(10000):
        v = r.raw()
    assert v == 4123659995
    r.close()


def test_determinism_and_distribution():
    a = O.Mt19937(42)
    b = O.Mt19937(42)
    seq_a = [a.uniform_int(0, 9) for _ in range(100)]
    seq_b = [b.uniform_int(0, 9) for _ in range(100)]
    assert seq_a == seq_b
    assert set(seq_a) <= set(range(10))
    fa = [a.uniform_float() for _ in range(100)]
    assert all(0.0 <= x < 1.0 for x in fa)
    a.close(); b.close()


def _solvable(wall, start, goal):
    import collections

    D = wall.shape[0]
    seen = {start}
    q = collections.deque([start])
    while q:
        x, y = q.popleft()
        if (x, y) == goal:
            return True
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = x + dx, y + dy
            if 0 <= nx < D and 0 <= ny < D and not wall[nx, ny] \
                    and (nx, ny) not in seen:
                seen.add((nx, ny))
                q.append((nx, ny))
    return False


def test_maze_layout_replay_properties():
    dims = set()
    for seed in range(20):
        lay = O.reference_maze_layout(seed, "easy")
        D = lay["maze_dim"]
        dims.add(D)
        assert D % 2 == 1 and 3 <= D <= 15
        wall = lay["wall"]
        # rooms at even-even coords are open (Kruskal invariant)
        assert not wall[::2, ::2].any()
        # goal on an open, non-start cell
        gi, gj = lay["goal"]
        assert not wall[gi, gj] and (gi, gj) != (0, 0)
        # maze is connected start -> goal
        assert _solvable(wall, (0, 0), (gi, gj))
        assert 0 <= lay["bg_index"] <= 8
        assert 0.0 <= lay["bg_offset"] < 1.0
    assert len(dims) > 1  # seed variety exercises multiple sizes


def test_climber_layout_replay_properties():
    for seed in range(15):
        lay = O.reference_climber_layout(seed)
        d = lay["difficulty"]
        assert 1 <= d <= 3
        assert d * d + 1 <= lay["num_platforms"] <= (d + 1) ** 2 + 1
        # platforms climb in steps of 3..4 within [1, H)
        assert len(lay["crystals"]) >= 1  # last platform always spawns one
        for (x, y) in lay["crystals"]:
            assert 0 < x < 19
        for (x, y, s) in lay["mobs"]:
            assert 3 <= x <= 16 and s in (-1, 1)
        # borders intact
        g = lay["grid"]
        assert (g[0] == 2).all() and (g[19] == 2).all()
        # floor is wall_top except corners (columns overwrite them,
        # tilemap.cpp:90-93 order)
        assert (g[1:19, 0] == 1).all()


def test_layout_is_seed_deterministic():
    a = O.reference_maze_layout(1234, "hard")
    b = O.reference_maze_layout(1234, "hard")
    np.testing.assert_array_equal(a["wall"], b["wall"])
    assert a["goal"] == b["goal"] and a["bg_index"] == b["bg_index"]


# ---------------------------------------------------------------------------
# the copy against the JAX package's oracle
# ---------------------------------------------------------------------------

def test_library_is_built_from_the_source():
    """The port's library is its own build of native/rng_oracle.cpp,
    named by the hash of the source and the flags, not the committed
    binary the JAX package loads."""
    O._load()
    path = O.library_path()
    assert path.is_file() and path.parent == O.BUILD_DIR
    assert path.name.startswith("rng_oracle-")
    assert path.resolve() != (O.SOURCE.parent / "librng_oracle.so").resolve()
    assert O.build() == path  # built once, then found


@pytest.mark.parametrize("seed", SEEDS)
def test_streams_match_jax(seed):
    """raw, uniform_int (several spans, negative bounds) and
    uniform_float (unit and scaled) draws, interleaved, and a USet's
    iteration order after inserts, copy-assignment and more inserts."""
    a, b = O.Mt19937(seed), J.Mt19937(seed)
    spans = ((0, 1), (0, 9), (-5, 5), (0, 2 ** 31 - 2), (3, 3), (0, 624))
    try:
        for i in range(300):
            lo, hi = spans[i % len(spans)]
            assert a.raw() == b.raw()
            assert a.uniform_int(lo, hi) == b.uniform_int(lo, hi)
            fa, fb = a.uniform_float(), b.uniform_float()
            assert np.float32(fa).view(np.int32) == np.float32(fb).view(np.int32)
            fa, fb = a.uniform_float(-2.5, 7.0), b.uniform_float(-2.5, 7.0)
            assert np.float32(fa).view(np.int32) == np.float32(fb).view(np.int32)
    finally:
        a.close(); b.close()

    vals = np.random.default_rng(seed).integers(0, 2000, 300)
    with O.USet() as u, J.USet() as v, O.USet() as u2, J.USet() as v2:
        for x in vals[:200]:
            u.insert(int(x)); v.insert(int(x))
        u2.assign_from(u); v2.assign_from(v)
        for x in vals[200:]:
            u2.insert(int(x)); v2.insert(int(x))
        assert u.items() == v.items() and u2.items() == v2.items()
        assert u2.size() == v2.size()
        assert [u2.contains(int(x)) for x in range(0, 2000, 7)] == \
            [v2.contains(int(x)) for x in range(0, 2000, 7)]


def _same(want, got, where):
    """Exact equality of two layout values: dicts key by key, sequences
    item by item, arrays in dtype, shape and value, numbers in type and
    value (floats bitwise)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(want) == list(got), where
        for k in want:
            _same(want[k], got[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(want) is type(got) and len(want) == len(got), where
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert want.dtype == got.dtype and want.shape == got.shape, where
        assert want.tobytes() == got.tobytes(), where
    else:
        assert type(want) is type(got), (where, type(want), type(got))
        if isinstance(want, float):
            assert np.float64(want).view(np.int64) == \
                np.float64(got).view(np.int64), where
        else:
            assert want == got, where


LAYOUTS = (
    [("maze", {"mode": m}) for m in ("easy", "hard", "memory")]
    + [("chaser", {"mode": m}) for m in ("easy", "hard", "extreme")]
    + [("jumper", {"mode": m}) for m in ("easy", "hard", "memory")]
    + [("caveflyer", {"mode": m}) for m in ("easy", "hard", "memory")]
    + [("climber", {"easy_mode": e}) for e in (False, True)]
    + [("coinrun", {}), ("coinrun", {"easy_mode": True})]
    + [("coinrun", {flag: False}) for flag in
       ("allow_pit", "allow_crate", "allow_dy", "allow_mobs")]
    + [("bossfight", {})]
)


@pytest.mark.parametrize("game,kw", LAYOUTS,
                         ids=[f"{g}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for g, kw in LAYOUTS])
def test_layouts_match_jax(game, kw):
    fn = f"reference_{game}_layout"
    for seed in SEEDS:
        want = getattr(J, fn)(seed, **kw)
        got = getattr(O, fn)(seed, **kw)
        _same(want, got, f"{game} {kw} seed {seed}")
