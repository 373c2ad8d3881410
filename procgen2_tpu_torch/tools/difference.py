"""Difference harness: the port's engine vs a reference .so under identical
actions, and recorded fixtures (the port's copy of
procgen2_tpu/tools/difference.py).

Automated version of the reference's manual difference_viewer.py
(SURVEY.md §4): steps both environments with the same action sequence
and reports per-step reward/termination agreement plus pixel statistics.
The reference's C++ RNG (std::mt19937 + libstdc++ distributions) cannot
be seed-matched to the engine's threefry keys, so `run_difference`
measures *distributional* and *mechanical* parity — identical action
semantics, reward values, termination rules — rather than per-seed level
equality (SURVEY.md §2.4). Per-seed parity is the fixtures' job: they
replay on the reference's own level (tools/reference_levels, the mt19937
oracle).

Expected pixel-difference budget against a reference-recorded fixture
(deliberate renderer deviations; not parity bugs):

- Nearest-neighbor texture sampling vs SDL's software scaler with
  src-rect padding/jitter compensation (`renderer.cpp:59-70`): ~1 px of
  sprite-rim disagreement per sprite edge.
- Rotated sprites draw from quantized pre-rasterized variants:
  jumper's compass needle 64 bins (`games/jumper.py`), caveflyer ship /
  bossfight bullet headings 16-32 bins.
- Small sprites composite as pixel-snapped stamps.
- Blending accumulates in bf16 (+-1 of 255 per blend).
- Default art is procedural; install `render/png_assets` (`--assets`)
  for the reference's PNG look.

Run (the headless reference builds in-repo — docs/REFERENCE_EXECUTION.md):

    make -C native reference
    python -m procgen2_tpu_torch.tools.difference maze \\
        --lib native/build/ref_maze.so --steps 500 [--device cpu]
    python -m procgen2_tpu_torch.tools.difference --fixture fx.npz \\
        [--all-episodes] [--assets DIR] [--device cpu]

Fixtures (`.npz`: game, seed, actions i32[T], frames u8[T, 64, 64, 3],
rewards f32[T], terminated bool[T]) have the JAX package's format, so a
fixture recorded by either package replays in the other. The engine runs
on `device` (the card by default); frames come back to the host.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import make
from .. import random as prng
from .reference_levels import reference_bank


@dataclasses.dataclass
class DiffReport:
    steps: int
    reward_values_ours: dict
    reward_values_ref: dict
    episodes_ours: int
    episodes_ref: int
    mean_pixel_abs_diff: float

    def __str__(self):
        return (
            f"steps={self.steps}\n"
            f"reward value histogram (ours): {self.reward_values_ours}\n"
            f"reward value histogram (ref):  {self.reward_values_ref}\n"
            f"episodes finished ours/ref: {self.episodes_ours}/{self.episodes_ref}\n"
            f"mean |pixel| diff: {self.mean_pixel_abs_diff:.2f}"
        )


def _action(a: int, device) -> torch.Tensor:
    return torch.tensor([int(a)], dtype=torch.int32, device=device)


def run_difference(game: str, lib_path: str, steps: int = 500, seed: int = 0,
                   device="cuda", **config) -> DiffReport:
    """Step the port's env (a bank of 64 levels from key(seed), one env
    reset with key(seed + 1)) and the reference .so side by side under
    the same uniform random actions; histogram both reward streams and
    average the per-step mean |pixel| difference."""
    from .cenv_loader import ReferenceEnv

    ref = ReferenceEnv(lib_path, seed=seed)
    env = make(game, device=device, **config)
    dev = env.device
    bank = env.generate_bank(prng.key(seed, dev), 64)
    state, ts = env.reset(bank, prng.key(seed + 1, dev), 1)
    ref.reset(seed=seed)

    rng = np.random.default_rng(seed)
    hist_ours: dict = {}
    hist_ref: dict = {}
    eps_ours = eps_ref = 0
    pix = []
    for _ in range(steps):
        a = int(rng.integers(0, 15))
        state, ts = env.step(bank, state, _action(a, dev))
        obs_ref, r_ref, term_ref, _ = ref.step(a)
        r_ours = round(float(ts.reward[0]), 3)
        r_ref = round(r_ref, 3)
        hist_ours[r_ours] = hist_ours.get(r_ours, 0) + 1
        hist_ref[r_ref] = hist_ref.get(r_ref, 0) + 1
        eps_ours += bool(ts.terminated[0])
        eps_ref += term_ref
        if term_ref:
            ref.reset()
        pix.append(np.abs(ts.obs[0].cpu().numpy().astype(np.float32)
                          - obs_ref.astype(np.float32)).mean())
    ref.close()
    return DiffReport(
        steps=steps,
        reward_values_ours=hist_ours,
        reward_values_ref=hist_ref,
        episodes_ours=eps_ours,
        episodes_ref=eps_ref,
        mean_pixel_abs_diff=float(np.mean(pix)),
    )


@dataclasses.dataclass
class PixelReport:
    """Frame-set pixel comparison (cf. difference_viewer.py:84-85 —
    the reference's interactive signed-diff `(a - b) * 0.5 + 0.5`)."""

    frames: int
    mean_abs_diff: float  # mean |a - b| over all pixels (0..255 scale)
    max_abs_diff: float
    fraction_within_8: float  # pixels with |a - b| <= 8 / 255
    per_frame_mean: np.ndarray  # f32 [T]

    def __str__(self):
        return (
            f"frames={self.frames}\n"
            f"mean |pixel| diff: {self.mean_abs_diff:.2f}\n"
            f"max  |pixel| diff: {self.max_abs_diff:.0f}\n"
            f"pixels within +-8: {self.fraction_within_8 * 100:.1f}%"
        )


def compare_frames(ours: np.ndarray, ref: np.ndarray) -> PixelReport:
    """Pixel-difference report between two uint8 frame stacks [T, H, W, 3]."""
    a = np.asarray(ours, np.float32)
    b = np.asarray(ref, np.float32)
    if a.shape != b.shape:
        raise ValueError(f"frame shapes differ: {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    return PixelReport(
        frames=a.shape[0],
        mean_abs_diff=float(d.mean()),
        max_abs_diff=float(d.max()),
        fraction_within_8=float((d <= 8).mean()),
        per_frame_mean=d.reshape(d.shape[0], -1).mean(1),
    )


def signed_diff_image(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The reference viewer's signed-difference visualization
    (difference_viewer.py:84-85): `(a - b) * 0.5 + 0.5` mapped to uint8."""
    d = (np.asarray(a, np.float32) - np.asarray(b, np.float32)) / 255.0
    return np.clip(np.round((d * 0.5 + 0.5) * 255.0), 0, 255).astype(np.uint8)


def _save_fixture(out, game, seed, actions, frames, rewards, terms):
    np.savez_compressed(
        out, game=game, seed=seed,
        actions=np.asarray(actions, np.int32),
        frames=np.asarray(frames).astype(np.uint8),
        rewards=np.asarray(rewards, np.float32),
        terminated=np.asarray(terms, bool),
    )


def record_fixture(game: str, lib_path: str, out: str, steps: int = 200,
                   seed: int = 0) -> None:
    """Record a reference-.so trajectory into an .npz fixture.

    The frame stored at a terminal step is the reference's *terminal*
    frame (the engine renders before the manual reset — SURVEY.md §3.3,
    game_test.py:38-40). Replayed later (no .so required) by
    `run_fixture_diff` / `--fixture`.
    """
    from .cenv_loader import ReferenceEnv

    ref = ReferenceEnv(lib_path, seed=seed)
    ref.reset(seed=seed)
    rng = np.random.default_rng(seed)
    actions, frames, rewards, terms = [], [], [], []
    for _ in range(steps):
        a = int(rng.integers(0, 15))
        obs, r, term, _ = ref.step(a)
        actions.append(a)
        frames.append(obs.copy())
        rewards.append(r)
        terms.append(term)
        if term:
            ref.reset()
    ref.close()
    _save_fixture(out, game, seed, actions, np.stack(frames), rewards, terms)


def _engine_replay(game: str, seed: int, actions, episodes: str = "first",
                   device="cuda", **config):
    """Replay `actions` through the port's engine on the oracle-pinned
    reference level for `seed`, with the reference's episode semantics.

    Uses `step_raw` (no auto-reset) so the step that terminates returns
    the *terminal* state and frame — matching what `record_fixture`
    stores — then resets explicitly before the next action (the caller's
    job in the reference, game_test.py:38-40). Episode `e` resets with
    `fold_in(key(seed), e)`, as the JAX package's replay does, so a
    replay is bit-reproducible in either package.

    episodes="first": stop after the first terminal step (a
    reference-recorded fixture reseeds follow-on episodes from its
    *continued* mt19937 state, which the level oracle does not track).
    episodes="all": keep replaying (valid for engine-recorded fixtures,
    where both sides re-gather the same pinned level).

    Returns (frames u8[T', 64, 64, 3], rewards f32[T'], terms bool[T'])
    on the host, T' <= len(actions).
    """
    env = make(game, device=device, **config)
    dev = env.device
    bank = reference_bank(game, [seed], dev, **config)
    base = prng.key(seed, dev)
    state, _ = env.reset(bank, prng.fold_in(base, 0), 1)

    frames, rewards, terms = [], [], []
    episode = 0
    for a in actions:
        state, ts = env.step_raw(state, _action(a, dev))
        frames.append(ts.obs[0].cpu().numpy())
        rewards.append(float(ts.reward[0]))
        terms.append(bool(ts.terminated[0]))
        if terms[-1]:
            episode += 1
            if episodes == "first":
                break
            state, _ = env.reset(bank, prng.fold_in(base, episode), 1)
    return (np.stack(frames), np.asarray(rewards, np.float32),
            np.asarray(terms, bool))


def record_engine_fixture(game: str, out: str, actions, seed: int = 0,
                          device="cuda", **config) -> None:
    """Record an *engine* trajectory into the same .npz fixture format:
    golden fixtures for renderer/trajectory regression tests, recorded on
    the oracle-pinned reference level with the terminal-frame semantics
    of `record_fixture`. `run_fixture_diff(..., episodes="all")` on such a
    fixture, in either package and on either device, must report 100%
    agreement and zero pixel diff."""
    actions = np.asarray(actions, np.int32)
    frames, rewards, terms = _engine_replay(
        game, seed, actions, episodes="all", device=device, **config)
    _save_fixture(out, game, seed, actions, frames, rewards, terms)


def run_fixture_diff(fixture_path: str, episodes: str = "first",
                     device="cuda", **config):
    """Replay a recorded fixture through the port's engine on the
    *reference's own level* (mt19937-oracle-predicted, reference_levels)
    and report reward/termination agreement plus a pixel report.

    The oracle pins the level layout to the reference seed, so frames are
    comparable scene for scene. Terminal steps compare terminal frames
    (`step_raw` replay); by default the comparison stops at the
    fixture's first episode boundary — see `_engine_replay` for why.
    Reward/termination agreement has no budget: it must be 1.0.
    """
    with np.load(fixture_path, allow_pickle=False) as fx:
        game = str(fx["game"])
        seed = int(fx["seed"])
        actions = fx["actions"]
        frames_fx = fx["frames"]
        rewards_fx = fx["rewards"]
        terms_fx = fx["terminated"]

    frames, rewards, terms = _engine_replay(
        game, seed, actions, episodes=episodes, device=device, **config)
    n = frames.shape[0]
    pix = compare_frames(frames, frames_fx[:n])
    reward_match = float(np.mean(np.isclose(rewards, rewards_fx[:n])))
    term_match = float(np.mean(terms == terms_fx[:n]))
    return dict(
        reward_agreement=reward_match,
        termination_agreement=term_match,
        pixel=pix,
        steps_compared=n,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("game", nargs="?")
    parser.add_argument("--lib", help="path to reference .so")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--record", metavar="OUT.npz",
                        help="record a reference fixture (needs --lib)")
    parser.add_argument("--fixture", metavar="IN.npz",
                        help="compare against a recorded fixture (no .so)")
    parser.add_argument("--all-episodes", action="store_true",
                        help="replay past episode boundaries (engine-"
                             "recorded fixtures only; see run_fixture_diff)")
    parser.add_argument("--assets", metavar="DIR",
                        help="overlay reference PNG assets before comparing")
    parser.add_argument("--device", default="cuda",
                        help="where the engine runs (cuda or cpu)")
    args = parser.parse_args(argv)
    if args.assets:
        from ..render import png_assets

        png_assets.install(args.assets)
    if args.record:
        record_fixture(args.game, args.lib, args.record,
                       steps=args.steps, seed=args.seed)
        print(f"recorded {args.steps} steps -> {args.record}")
        return
    if args.fixture:
        rep = run_fixture_diff(
            args.fixture, episodes="all" if args.all_episodes else "first",
            device=args.device)
        print(f"steps compared:        {rep['steps_compared']}")
        print(f"reward agreement:      {rep['reward_agreement'] * 100:.1f}%")
        print(f"termination agreement: {rep['termination_agreement'] * 100:.1f}%")
        print(rep["pixel"])
        return
    print(run_difference(args.game, args.lib, steps=args.steps,
                         seed=args.seed, device=args.device))


if __name__ == "__main__":
    main()
