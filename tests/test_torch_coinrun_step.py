"""Coinrun's step kernel off the card: CPU tensors take the plain torch
step and build and launch nothing; the kernel wrapper's checks raise
before any build; the constants and LUTs it is handed agree with the
kernel's source and with the plain step's rounding; and the crafted
lanes that the card tests hold the kernel on cover their cases under
the plain step. The kernel against the plain step, bit for bit:
tests/test_torch_cuda.py on the card."""
import ctypes
import pathlib
import re

import pytest
import torch

import coinrun_lanes as lanes
import procgen2_tpu_torch as pt
from procgen2_tpu_torch.games import coinrun
from procgen2_tpu_torch.physics import coinrun_step as cs
from procgen2_tpu_torch.physics import tiles
from procgen2_tpu_torch.render import _build
from procgen2_tpu_torch.utils import tree_map
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SOURCE = pathlib.Path(_build.CSRC) / "coinrun_step.cu"


@pytest.fixture
def no_build(monkeypatch):
    """Any build or load of a kernel fails the test."""
    def refuse(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", refuse)
    cs._kernel.cache_clear()


def _state(n=4, **cfg):
    env = pt.make("coinrun", device="cpu", **cfg)
    bank = env.generate_bank(pt.random.key(0), 4)
    state, _ = env.reset(bank, pt.random.key(1), n)
    return env, bank, state


def test_cpu_step_takes_the_plain_path(no_build):
    env, bank, state = _state()
    before = cs.step.launches
    a = torch.tensor([7, 5, 3, 1], dtype=torch.int32)
    for _ in range(3):
        gs, reward, done, _ = coinrun.step(env.cfg, state.game, a)
        want = coinrun.step_reference(env.cfg, state.game, a)
        tree_map(lambda x, y: None if torch.equal(x, y)
                 else pytest.fail("differs"), (gs, reward, done), want[:3])
        state, _ = env.step(bank, state, a)
    assert cs.step.launches == before
    assert cs._kernel.cache_info().currsize == 0


def _args(gs, n):
    lv = gs.level
    return dict(grid=lv.grid, pos=gs.pos, vel=gs.vel, on_ground=gs.on_ground,
                face_forward=gs.face_forward, anim_t=gs.anim_t,
                mob_pos=gs.mob_pos, mob_vx=gs.mob_vx, mob_alive=lv.mob_alive,
                saw_pos=lv.saw_pos, saw_alive=lv.saw_alive,
                coin_pos=lv.coin_pos, t=gs.t,
                action=torch.zeros(n, dtype=torch.int32))


BAD_INPUTS = {
    "grid dtype": lambda a: dict(a, grid=a["grid"].to(torch.int32)),
    "pos shape": lambda a: dict(a, pos=a["pos"][:, :1]),
    "anim_t dtype": lambda a: dict(a, anim_t=a["anim_t"].double()),
    "on_ground dtype": lambda a: dict(a, on_ground=a["on_ground"].int()),
    "mob_alive shape": lambda a: dict(a, mob_alive=a["mob_alive"][:, :3]),
    "saw_pos shape": lambda a: dict(a, saw_pos=a["saw_pos"][1:]),
    "action dtype": lambda a: dict(a, action=a["action"].long()),
    "action device": lambda a: dict(a, action=a["action"].to("meta")),
    "cpu tensors": lambda a: a,
    "meta tensors": lambda a: {k: v.to("meta") for k, v in a.items()},
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_kernel_wrapper_checks_before_any_build(no_build, case):
    _, _, state = _state()
    args = BAD_INPUTS[case](_args(state.game, 4))
    with pytest.raises(ValueError):
        cs.step(**args, consts=coinrun._STEP_CONSTS, luts=coinrun._STEP_LUTS,
                oob=coinrun.WALL_MID, sub_steps=coinrun.SUB_STEPS)
    assert cs._kernel.cache_info().currsize == 0


def test_kernel_wrapper_refuses_slots_beyond_two_a_lane(no_build):
    _, _, state = _state()
    args = {k: v.to("meta") for k, v in _args(state.game, 4).items()}
    many = cs.MAX_SLOTS + 1
    args.update(mob_pos=torch.zeros((4, many, 2), device="meta"),
                mob_vx=torch.zeros((4, many), device="meta"),
                mob_alive=torch.zeros((4, many), dtype=torch.bool,
                                      device="meta"))
    with pytest.raises(ValueError):
        cs.step(**args, consts=coinrun._STEP_CONSTS, luts=coinrun._STEP_LUTS,
                oob=coinrun.WALL_MID, sub_steps=coinrun.SUB_STEPS)


def test_consts_are_the_kernel_struct():
    """`Consts` lists the f32 fields of the source's `struct Consts` in its
    order, so that ctypes lays it out as the kernel reads it."""
    body = re.search(r"struct Consts \{(.*?)\};", SOURCE.read_text(),
                     re.S).group(1)
    fields = re.findall(r"^\s*float (\w+);", body, re.M)
    assert fields == [name for name, _ in cs.Consts._fields_]
    assert all(t is ctypes.c_float for _, t in cs.Consts._fields_)


def test_consts_round_as_torch_rounds_the_scalars():
    """Each constant is the f32 that torch makes of the plain step's Python
    float when it meets an f32 tensor, and none is left unset."""
    want = dict(dt=coinrun.DT, mix_ground=coinrun.MIX,
                mix_air=coinrun.MIX * coinrun.AIR_CONTROL,
                max_speed=coinrun.MAX_SPEED, max_jump=coinrun.MAX_JUMP,
                gravity_dt=coinrun.GRAVITY * coinrun.DT,
                anim_dt=0.1 * coinrun.DT, down_only_vy=0.01, sensor_dy=0.6,
                mob_top=0.48, mob_h=0.98, coin_reward=10.0)
    assert set(want) == {name for name, _ in cs.Consts._fields_}
    zero = torch.zeros(1, dtype=torch.float32)
    for name, value in want.items():
        assert getattr(coinrun._STEP_CONSTS, name) == (zero + value).item()


@pytest.mark.parametrize("which", range(4))
def test_packed_luts_are_apply_lut(which):
    """Every int8 tile id gets the type `_apply_lut` gives it from the
    packed LUT, as the kernel unpacks it (tiles.cuh: lut_type)."""
    lut = (coinrun._LUT_AGENT, coinrun._LUT_LAVA, coinrun._LUT_WALL,
           coinrun._LUT_EMPTY)[which]
    packed = coinrun._STEP_LUTS[which]
    ids = torch.arange(-128, 128, dtype=torch.int32)
    want = tiles._apply_lut(ids, lut)
    got = [(packed >> (2 * i)) & 3 if 0 <= i < cs.LUT_IDS else tiles.NONE
           for i in ids.tolist()]
    assert want.tolist() == got


def test_pack_lut_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError):
        cs.pack_lut((0,) * (cs.LUT_IDS + 1))
    with pytest.raises(ValueError):
        cs.pack_lut((0, 3))


def test_crafted_lanes_cover_their_cases():
    """Under the plain step the crafted lanes end in sub-steps 1, 2 and 3
    on the coin, the saw and lava, land on the one-way crate, fall through
    it pressing down, pass up through it from below, and walk into a mob;
    the mobs turn at the wall and at the ledge; a dead mob is left as it
    is."""
    env, _, state = _state(lanes.N)
    gs, a = lanes.crafted(state.game)
    g1, reward, done, _ = coinrun.step_reference(env.cfg, gs, a)
    k = lanes.active_sub_steps(g1.anim_t)
    for name, want in (("coin", 10.0), ("saw", 0.0)):
        s = lanes.group(name)
        assert bool(done[s].all()) and bool((reward[s] == want).all())
        assert set(k[s].tolist()) >= {1, 2, 3}
    s = lanes.group("lava")
    assert set(k[s][done[s]].tolist()) >= {2, 3}
    s = lanes.group("land")
    assert bool(g1.on_ground[s].all()) and bool((g1.pos[s, 1] == 55.0).all())
    g = gs
    for _ in range(8):
        g, _, _, _ = coinrun.step_reference(env.cfg, g, a)
        assert torch.equal(g.mob_pos[:, lanes.DEAD_MOB],
                           gs.mob_pos[:, lanes.DEAD_MOB])
    s = lanes.group("through")
    assert bool((g.pos[s, 1] == 60.0).all())  # on the floor below the crate
    for name in ("below", "jump"):
        s = lanes.group(name)
        assert bool((g.pos[s, 1] < lanes.CRATE_ROW).all())  # above it
    assert bool(done[lanes.group("mob")].any())
    assert bool((g.mob_vx[:, 0] < 0).any())  # turned at the wall
    assert bool((g1.mob_vx[:, 1] < 0).any())  # turned at the ledge
