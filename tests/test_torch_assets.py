"""The port's own asset modules (procgen2_tpu_torch/render/atlas.py and
phases.py, numpy copies cut to what coinrun, bossfight, climber,
caveflyer, jumper, chaser and maze draw)
against the JAX package's: every bank these games build must be
identical, array for array, and so must the asset tables, phase tables,
window spans and expansion tables they come from."""
import numpy as np
import pytest

from procgen2_tpu.games import bossfight as jboss
from procgen2_tpu.games import caveflyer as jcave
from procgen2_tpu.games import chaser as jchase
from procgen2_tpu.games import climber as jclimb
from procgen2_tpu.games import coinrun as jcoin
from procgen2_tpu.games import jumper as jjump
from procgen2_tpu.games import maze as jmaze
from procgen2_tpu.render import atlas as jatlas
from procgen2_tpu.render import phases as jphases
from procgen2_tpu_torch.games import bossfight as tboss
from procgen2_tpu_torch.games import caveflyer as tcave
from procgen2_tpu_torch.games import chaser as tchase
from procgen2_tpu_torch.games import climber as tclimb
from procgen2_tpu_torch.games import coinrun as tcoin
from procgen2_tpu_torch.games import jumper as tjump
from procgen2_tpu_torch.games import maze as tmaze
from procgen2_tpu_torch.render import atlas as tatlas
from procgen2_tpu_torch.render import phases as tphases


def same(want, got, what):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), what
        for k in want:
            same(want[k], got[k], f"{what}[{k!r}]")
        return
    if isinstance(want, (tuple, list)):
        assert len(want) == len(got), what
        for i, (w, g) in enumerate(zip(want, got)):
            same(w, g, f"{what}[{i}]")
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert want.dtype == got.dtype and want.shape == got.shape, what
        np.testing.assert_array_equal(want, got, err_msg=what)
        return
    assert want == got, what


def same_kept(want, got, what):
    """`same`, over the entries of `got` where both are dicts: the port's
    games keep the assets their ported paths use."""
    if isinstance(got, dict):
        assert set(got) <= set(want), what
        want = {k: want[k] for k in got}
    same(want, got, what)


@pytest.mark.parametrize("fn", ["_assets", "_stamp_banks", "_scene_assets"])
def test_coinrun_banks_identical(fn):
    args = (4,) if fn == "_scene_assets" else ()
    same_kept(getattr(jcoin, fn)(*args), getattr(tcoin, fn)(*args),
              f"coinrun.{fn}")


@pytest.mark.parametrize("fn", ["_assets", "_stamp_banks", "_bg_bank"])
def test_bossfight_banks_identical(fn):
    same_kept(getattr(jboss, fn)(), getattr(tboss, fn)(), f"bossfight.{fn}")


@pytest.mark.parametrize("fn", ["_assets", "_stamp_banks", "_scene_assets"])
def test_climber_banks_identical(fn):
    args = (4,) if fn == "_scene_assets" else ()
    same_kept(getattr(jclimb, fn)(*args), getattr(tclimb, fn)(*args),
              f"climber.{fn}")


@pytest.mark.parametrize("fn,args", [
    ("_assets", ()), ("_stamp_banks", ()), ("_scene_assets", (4, 20)),
    ("_scene_assets", (4, 40)), ("_scene_assets", (4, 45))])
def test_caveflyer_banks_identical(fn, args):
    """The atlas and space backgrounds, the four pixel banks (objects,
    bullets, ship, smoke) and the scene assets of the three cave sizes."""
    same_kept(getattr(jcave, fn)(*args), getattr(tcave, fn)(*args),
              f"caveflyer.{fn}{args}")


@pytest.mark.parametrize("fn,args", [
    ("_assets", ()), ("_stamp_banks", ()), ("_compass_overlay", (64,)),
    ("_scene_assets", (4, 20)), ("_scene_assets", (4, 40)),
    ("_scene_assets", (4, 45))])
def test_jumper_banks_identical(fn, args):
    """The atlas (climber's tile themes, carrot, spikeman, dust circle,
    compass circle, needle yellow, bunny poses) and sky backgrounds, the
    moving / bunny / needle pixel banks, the compass overlay (the atlas
    fallback: no reference PNG is installed) and the scene assets of the
    three world sizes."""
    same_kept(getattr(jjump, fn)(*args), getattr(tjump, fn)(*args),
              f"jumper.{fn}{args}")


def test_jumper_sprites_identical():
    """The raw sprites jumper's compass overlay samples (`sprite_rgba`),
    and every sprite of jumper's atlas."""
    for name in ("carrot", "spikeman", "compass_circle", "solid_yellow",
                 "bunny_stand", "bunny_jump", "bunny_walk1", "bunny_walk2"):
        same(jatlas.sprite_rgba(name), tatlas.sprite_rgba(name), name)


def test_maze_assets_identical():
    """Maze's atlas (the sand wall, cheese and mouse) and its 9 topdown
    backgrounds."""
    same(jmaze._assets()[:3], tmaze._assets(), "maze._assets")


@pytest.mark.parametrize("mode", ["easy", "hard", "extreme"])
def test_chaser_banks_identical(mode):
    """Chaser's atlas (stone wall, pellet, crystal, egg, the three flyer
    frames, the fleeing walker, the floater) and backgrounds, and the
    pixel bank of its stamp group at the mode's ppu
    (64/11, 64/13, 64/19: P = 8, 7, 6)."""
    same_kept(jchase._assets(), tchase._assets(), "chaser._assets")
    ppu = 64 / tchase.Config(mode=mode).world_dim
    same(jchase._stamp_banks(ppu), tchase._stamp_banks(ppu),
         f"chaser._stamp_banks({ppu})")


def test_maze_and_chaser_sprites_identical():
    for name in ("maze_wall", "cheese", "mouse", "stone_wall",
                 "chaser_point", "crystal", "egg_spikey", "flyer0", "flyer1",
                 "flyer2", "walker_flee", "floater"):
        same(jatlas.sprite_rgba(name), tatlas.sprite_rgba(name), name)


def test_climber_merged_bank_identical():
    """The render's one stamp group bank, as climber.py:581-582 builds it."""
    banks = jclimb._stamp_banks()
    same(np.concatenate([np.asarray(banks["moving"]),
                         np.asarray(banks["agent"])], axis=0),
         tclimb._merged_bank(), "climber merged bank")


@pytest.mark.parametrize("ppu", [3.2, 4.8, 16.0])
@pytest.mark.parametrize("qp", [1, 4])
def test_win_and_expansion_tables_identical(ppu, qp):
    assert tphases.win(ppu, 64, qp) == jphases.win(ppu, 64, qp)
    same(jphases.expansion_tables(ppu, 64, qp),
         tphases.expansion_tables(ppu, 64, qp), f"expansion_tables({ppu})")
    W = jphases.win(ppu, 64, qp) + 3
    same(jphases.expansion_tables(ppu, 64, qp, win_size=W),
         tphases.expansion_tables(ppu, 64, qp, win_size=W),
         f"expansion_tables({ppu}, win_size={W})")
    with pytest.raises(ValueError):
        tphases.expansion_tables(ppu, 64, qp, win_size=W - 4)


def test_tables_identical():
    for name in ("WALL_THEMES", "WALKING_ENEMIES", "CRATE_TYPES",
                 "AGENT_THEMES", "BOSS_SHIP_COLORS", "PLAYER_SHIP_COLORS",
                 "LASER_COLORS", "CLIMBER_TILE_THEMES",
                 "CLIMBER_AGENT_THEMES", "SPRITE_SIZE", "BG_SIZE"):
        same(getattr(jatlas, name), getattr(tatlas, name), name)
    assert tphases.WIN == jphases.WIN
    for ppu in (tcoin.PPU, 16.0):
        for qp in (1, 4):
            same(jphases.phase_tables(ppu, 64, qp),
                 tphases.phase_tables(ppu, 64, qp), f"phase_tables({ppu}, {qp})")


@pytest.mark.parametrize("kind,n", [("sky", 49), ("space", 13),
                                    ("topdown", 9)])
def test_backgrounds_identical(kind, n):
    same(jatlas.build_backgrounds(kind, n), tatlas.build_backgrounds(kind, n),
         kind)


def test_rasterized_patches_identical():
    """Rotated, flipped and stretched patches of every sprite the port
    keeps."""
    rng = np.random.default_rng(0)
    for name in sorted(tatlas._REGISTRY):
        w, h = rng.uniform(2.0, 30.0, 2)
        rot = float(rng.uniform(0, 2 * np.pi))
        flip = bool(rng.random() < 0.5)
        same(jatlas.rasterize_patch(name, w, h, rot, 12, flip),
             tatlas.rasterize_patch(name, w, h, rot, 12, flip), name)


def test_unknown_sprite_raises():
    with pytest.raises(KeyError):
        jatlas.build_atlas(("no_such_sprite",))
    with pytest.raises(KeyError):
        tatlas.build_atlas(("no_such_sprite",))
