"""Bossfight's step kernel off the card: CPU tensors take the plain torch
step and build and launch nothing; the kernel wrapper's checks raise
before any build; the constants and the state's fields it is handed agree
with the kernel's source and with the plain step's rounding; and the
crafted lanes that the card tests hold the kernel on cover their cases
under the plain step. The kernel against the plain step, bit for bit:
tests/test_torch_cuda.py on the card."""
import ctypes
import dataclasses
import pathlib
import re

import pytest
import torch

import bossfight_lanes as lanes
import procgen2_tpu_torch as pt
from procgen2_tpu_torch.games import bossfight as bf
from procgen2_tpu_torch.physics import bossfight_step as bs
from procgen2_tpu_torch.render import _build
from procgen2_tpu_torch.utils import tree_map
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SOURCE = pathlib.Path(_build.CSRC) / "bossfight_step.cu"


@pytest.fixture
def no_build(monkeypatch):
    """Any build or load of a kernel fails the test."""
    def refuse(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", refuse)
    bs._kernel.cache_clear()


def _state(n=4, mode="hard"):
    env = pt.make("bossfight", device="cpu", mode=mode)
    bank = env.generate_bank(pt.random.key(0), 4)
    state, _ = env.reset(bank, pt.random.key(1), n)
    return env, bank, state


def test_cpu_step_takes_the_plain_path(no_build):
    env, bank, state = _state()
    before = bs.step.launches
    a = torch.tensor([9, 5, 3, 1], dtype=torch.int32)
    for _ in range(3):
        got = bf.step(env.cfg, state.game, a)
        want = bf.step_reference(env.cfg, state.game, a)
        tree_map(lambda x, y: None if torch.equal(x, y)
                 else pytest.fail("differs"), got[:3], want[:3])
        state, _ = env.step(bank, state, a, render=False)
    assert bs.step.launches == before
    assert bs._kernel.cache_info().currsize == 0


def _args(gs, n):
    return dict(fields=[getattr(gs, f) for f in bf._STEP_FIELDS],
                barrier_pos=gs.level.barrier_pos,
                barrier_exists=gs.level.barrier_exists,
                action=torch.zeros(n, dtype=torch.int32))


def _field(name, fn):
    i = bf._STEP_FIELDS.index(name)
    return lambda a: dict(a, fields=[fn(x) if k == i else x
                                     for k, x in enumerate(a["fields"])])


BAD_INPUTS = {
    "a field short": lambda a: dict(a, fields=a["fields"][:-1]),
    "pos shape": _field("pos", lambda x: x[:, :1]),
    "alive dtype": _field("alive", lambda x: x.int()),
    "bb_pos shape": _field("bb_pos", lambda x: x[:, :32]),
    "ex_frame dtype": _field("ex_frame", lambda x: x.double()),
    "rng dtype": _field("rng", lambda x: x.int()),
    "t device": _field("t", lambda x: x.to("meta")),
    "barrier_pos shape": lambda a: dict(a, barrier_pos=a["barrier_pos"][1:]),
    "barrier_exists dtype": lambda a: dict(
        a, barrier_exists=a["barrier_exists"].int()),
    "action dtype": lambda a: dict(a, action=a["action"].long()),
    "cpu tensors": lambda a: a,
    "meta tensors": lambda a: dict(
        fields=[x.to("meta") for x in a["fields"]],
        **{k: v.to("meta") for k, v in a.items() if k != "fields"}),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_kernel_wrapper_checks_before_any_build(no_build, case):
    env, _, state = _state()
    args = BAD_INPUTS[case](_args(state.game, 4))
    with pytest.raises(ValueError):
        bs.step(**args, consts=bf._step_consts(env.cfg),
                sub_steps=bf.SUB_STEPS)
    assert bs._kernel.cache_info().currsize == 0


def test_consts_are_the_kernel_struct():
    """`Consts` lists the fields of the source's `struct Consts` in its
    order, with their types and array lengths, so that ctypes lays it out
    as the kernel reads it."""
    body = re.search(r"struct Consts \{(.*?)\};", SOURCE.read_text(),
                     re.S).group(1)
    ctype = {"float": ctypes.c_float, "int": ctypes.c_int}
    want = []
    for typ, name, length in re.findall(r"^\s*(float|int) (\w+)(?:\[(\w+)\])?;",
                                        body, re.M):
        want.append((name, ctype[typ] * bs.VOLLEY if length == "kVolley"
                     else ctype[typ]))
    assert not re.search(r"\[(?!kVolley\])", body)  # no other array length
    assert want == bs.Consts._fields_


def test_state_fields_are_the_kernel_list():
    """FIELDS are bossfight.State's fields after `level`, in its order, and
    the source's BOSSFIGHT_FIELDS with their element types."""
    names = [f.name for f in dataclasses.fields(bf.State)]
    assert names[0] == "level" and tuple(names[1:]) == bf._STEP_FIELDS
    body = re.search(r"#define BOSSFIGHT_FIELDS\(X\)(.*?)\n\n",
                     SOURCE.read_text(), re.S).group(1)
    ctype = {"float": torch.float32, "uint8_t": torch.bool,
             "int32_t": torch.int32, "int64_t": torch.int64}
    src = [(name, ctype[t]) for t, name in
           re.findall(r"X\((\w+), (\w+)\)", body)]
    assert src == [(name, dtype) for name, dtype, _ in bs.FIELDS]
    _, _, state = _state()
    for name, dtype, shape in bs.FIELDS:
        x = getattr(state.game, name)
        assert (x.dtype, tuple(x.shape)) == (dtype, (4,) + shape), name


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_consts_round_as_torch_rounds_the_scalars(mode):
    """Each constant is the f32 that torch makes of the plain step's Python
    float when it meets an f32 tensor, the volley tables are the plain
    step's, the mode sets the bullet speed and the shield jitter, and none
    is left unset."""
    cfg = bf.Config(mode=mode)
    c = bf._step_consts(cfg)
    H = bf.HALF
    want = dict(
        dt=bf.DT, move_mix=bf.MOVE_MIX, move_speed=bf.MOVE_SPEED,
        lo_x=bf._f32(-H + 0.15), hi_x=bf._f32(H - 0.15),
        lo_y=bf._f32(-H + 0.1), hi_y=bf._f32(H - 0.1),
        a_bullet_time=bf.A_BULLET_TIME, a_bullet_vy=-bf.A_BULLET_SPEED,
        bounce_speed=bf.BOUNCE_SPEED, bounce_time=bf.BOUNCE_TIME,
        explosion_dt=bf.EXPLOSION_RATE * bf.DT, agent_dx=0.15, agent_dy=0.1,
        agent_w=0.3, agent_h=0.2, boss_dx=0.6, boss_dy=0.4, boss_w=1.2,
        boss_h=0.8, bullet_half=0.01, bullet_size=0.02, barrier_half=0.1,
        barrier_size=0.2, half=H, unshielded_time=bf.UNSHIELDED_TIME,
        damage_time=bf.DAMAGE_TIME, move_time=bf.MOVE_TIME,
        inv_move_time=bf._INV_MOVE_TIME, target_x_scale=0.7,
        target_y_shift=0.3, pi=bf._PI, passive_p=0.1 * bf.DT,
        bullet_speed=cfg.bullet_speed, shield_jitter=cfg.shield_jitter)
    floats = {n for n, t in bs.Consts._fields_ if t is ctypes.c_float}
    assert set(want) == floats
    zero = torch.zeros(1, dtype=torch.float32)
    for name, value in want.items():
        assert getattr(c, name) == (zero + value).item(), name
    for name, table in zip(("fan", "cross", "radial"),
                           bf._volley_tables("cpu")):
        assert list(getattr(c, name)) == table.tolist(), name
    assert (c.boss_hp, c.num_weapons) == (bf.BOSS_HP, bf.NUM_WEAPONS)
    assert c.bullet_speed == (zero + (0.05 if mode == "easy" else 0.1)).item()


def test_crafted_lanes_cover_their_cases():
    """Under the plain step the crafted lanes die in sub-steps 1, 2, 3 and
    4 while the boss ring moves on, bounce off the shield and time out,
    take the boss to HP 0 and push into, expire from and are refused by
    the explosion pool, kill the boss (+10), hit barriers and leave the
    arena, fill both rings and are refused there, and fire volleys 0, 1,
    2 and 3 and the passive shot."""
    env, _, state = _state(lanes.N, "easy")
    gs, a = lanes.crafted(state.game)
    g1, reward, done, _ = bf.step_reference(env.cfg, gs, a)
    k = lanes.active_sub_steps(gs, g1)

    s = lanes.group("death")
    assert done[s].tolist() == [True] * 4 + [False, True, True, False]
    assert k[s].tolist() == [1, 2, 3, 4, 4, 1, 1, 4]
    assert not g1.alive[s].any() and (reward[s][done[s]] == -10.0).all()
    moved = gs.bb_pos[s, 1, 0]
    for _ in range(bf.SUB_STEPS):  # the boss ring ran every sub-step
        moved = moved + gs.bb_vel[s, 1, 0] * bf.DT
    assert torch.equal(g1.bb_pos[s, 1, 0], moved)

    s = lanes.group("bounce")
    assert g1.ab_bouncing[s, 1].all() and (g1.ab_frame[s, 1] == 0.0).all()
    assert (g1.ab_vel[s, 1, 1] == bf._f32(bf.BOUNCE_SPEED)).all()
    assert (g1.ab_frame[s, 0] == -1.0).all()  # every old bounce timed out
    assert (g1.ab_num[s] == 1).all()

    s = lanes.group("damage")
    assert (g1.phase_index[s] == gs.phase_index[s] + 1).all()
    assert done[s].tolist() == [False] * 6 + [True, True]
    assert (reward[s][6:] == 10.0).all()
    pushed = g1.ex_frame[s].gather(1, gs.ex_next[s, None].long())[:, 0]
    assert (pushed[gs.ex_num[s] < bf.NUM_EXPLOSIONS] >= 0.0).all()
    assert g1.ex_num[s].tolist() == [1, 7, 7] * 2 + [1, 7]  # 8: refused

    s = lanes.group("barrier")
    assert (g1.ab_frame[s, 0] > 1.0).all() and (g1.bb_frame[s, 0] > 1.0).all()
    assert (g1.ab_frame[s, 1] == -1.0).all() and (g1.bb_frame[s, 1] == -1.0).all()
    assert done[s].tolist() == [False] * 7 + [True]

    s = lanes.group("boss_ring")
    fired = torch.tensor([8] * 4 + [5] * 4)
    took = torch.minimum(fired, bf.NUM_B_BULLETS - gs.bb_num[s])
    assert g1.bb_num[s].tolist() == (gs.bb_num[s] + took).tolist()
    assert g1.bb_next[s].tolist() == (
        (gs.bb_next[s] + took) % bf.NUM_B_BULLETS).tolist()
    assert (took == 0).any() and (took < fired).any()

    s = lanes.group("agent_ring")
    full = gs.ab_num[s] == bf.NUM_A_BULLETS
    assert full.any() and torch.equal(g1.ab_num[s], gs.ab_num[s] + ~full)
    assert (g1.ab_next[s] == torch.where(
        full, gs.ab_next[s], (gs.ab_next[s] + 1) % bf.NUM_A_BULLETS)).all()

    s = lanes.group("volley")
    assert g1.bb_num[s].tolist() == [5, 4, 8, 1, 0, 0, 1, 0]
    assert g1.phase_index[s].tolist() == [0] * 5 + [1, 1, 2]
