"""Interactive pygame viewer (counterpart of interactive_viewer.py), on
the port's `GymEnv` (the port's copy of procgen2_tpu/tools/viewer.py).

Keyboard map mirrors the reference (interactive_viewer.py:44-70):
a/d = left/right, w = up/jump, s = down/fallthrough, e = fire/interact,
r = force reset, o = toggle obs view, q = quit. By default the scene is
re-rendered natively at the window resolution (`cenv_render`'s W x H
target, games/coinrun/coinrun.cpp:393-411) via GymEnv.render(size); `o`
switches to the upscaled 64x64 observation, mirroring
interactive_viewer.py:78-90's obs toggle.

Run:  python -m procgen2_tpu_torch.tools.viewer coinrun [--mode hard]
      [--device cpu]   (the env runs on the card by default; needs a
      display and pygame)
"""
from __future__ import annotations

import argparse

import numpy as np


def compute_action(ks, pygame) -> int:
    """Key -> 15-action mapping (the keymap interactive_viewer.py:44-70
    specifies). Movement actions form a 3x3 grid, action = 3*x + y with
    x in {left: 0, none: 1, right: 2} (a beats d) and
    y in {down: 0, neutral: 1, up: 2} (w beats s); e (fire) overrides."""
    if ks[pygame.K_e]:
        return 9
    x = 0 if ks[pygame.K_a] else 2 if ks[pygame.K_d] else 1
    y = 2 if ks[pygame.K_w] else 0 if ks[pygame.K_s] else 1
    return 3 * x + y


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("game")
    parser.add_argument("--mode", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--fps", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import pygame

    from ..core.gym_adapter import GymEnv

    config = {} if args.mode is None else {"mode": args.mode}
    env = GymEnv(args.game, seed=args.seed, device=args.device, **config)
    obs, _ = env.reset()

    pygame.init()
    screen = pygame.display.set_mode((args.size, args.size))
    pygame.display.set_caption(f"procgen2_tpu_torch — {args.game}")
    clock = pygame.time.Clock()

    ks_prev = pygame.key.get_pressed()
    running = True
    ep_return = 0.0
    show_obs = False  # 'o' toggles the 64x64 obs view
    while running:
        for event in pygame.event.get():
            if event.type == pygame.QUIT:
                running = False
        ks = pygame.key.get_pressed()
        if ks[pygame.K_q]:
            running = False
        if ks[pygame.K_o] and not ks_prev[pygame.K_o]:
            show_obs = not show_obs
        force_reset = ks[pygame.K_r] and not ks_prev[pygame.K_r]

        action = compute_action(ks, pygame)
        obs, reward, term, trunc, _ = env.step(action)
        ep_return += reward
        if term or force_reset:
            if term:
                print(f"episode return: {ep_return:+.2f}")
            ep_return = 0.0
            if force_reset:
                obs, _ = env.reset()

        frame = obs["screen"] if show_obs else env.render(size=args.size)
        surf = pygame.surfarray.make_surface(np.swapaxes(frame, 0, 1))
        if frame.shape[0] != args.size:
            surf = pygame.transform.scale(surf, (args.size, args.size))
        screen.blit(surf, (0, 0))
        ks_prev = ks
        pygame.display.flip()
        clock.tick(args.fps)

    pygame.quit()


if __name__ == "__main__":
    main()
