"""Scripted-trajectory helpers for parity tests and fixtures
(procgen2_tpu/tools/scripted.py, the port's own copy).

The BASELINE parity requirement is *bit-exact fixed-seed episode
returns*: on oracle-pinned reference levels (tools/reference_levels.py),
a scripted action sequence must reproduce the reference's per-step
reward/termination sequence exactly. These helpers plan such action
sequences from level layouts. The 15-action encoding is the original
procgen 3x3 movement grid (games/coinrun/common_systems.cpp:148-150):
x = {6,7,8} -> +1, {0,1,2} -> -1; special {2,5,8} = jump/up,
{0,3,6} = down.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np

LEFT, RIGHT, UP, DOWN, NOOP, FIRE = 1, 7, 5, 3, 4, 9
DOWN_LEFT, DOWN_RIGHT = 0, 6
UP_LEFT, UP_RIGHT = 2, 8


def bfs_actions(grid: np.ndarray, start: Tuple[int, int],
                goal: Tuple[int, int]) -> Optional[List[int]]:
    """Shortest 4-connected path over zero cells of `grid` (render
    coordinates: row 0 is the top) -> list of grid-move actions.

    Matches the discrete movement games (maze/chaser) where one action
    moves one cell: UP decreases the row index (games/maze/
    common_systems.cpp:88-101 maps action -> (dx, dy) in world coords;
    the render row axis is flipped, tools/reference_levels.py).
    """
    H, W = grid.shape
    prev = {tuple(start): None}
    q = deque([tuple(start)])
    goal = tuple(goal)
    while q:
        cur = q.popleft()
        if cur == goal:
            break
        y, x = cur
        for dy, dx, act in ((0, 1, RIGHT), (0, -1, LEFT),
                            (-1, 0, UP), (1, 0, DOWN)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W and grid[ny, nx] == 0 \
                    and (ny, nx) not in prev:
                prev[(ny, nx)] = (cur, act)
                q.append((ny, nx))
    if goal not in prev:
        return None
    acts: List[int] = []
    cur = goal
    while prev[cur] is not None:
        cur, act = prev[cur]
        acts.append(act)
    return acts[::-1]


def bfs_cell_path(grid: np.ndarray, start: Tuple[int, int],
                  goal: Tuple[int, int]) -> Optional[List[Tuple[int, int]]]:
    """Like `bfs_actions` but returns the visited (row, col) cells,
    start inclusive — for planners that need waypoints, not actions."""
    H, W = grid.shape
    prev = {tuple(start): None}
    q = deque([tuple(start)])
    goal = tuple(goal)
    while q:
        cur = q.popleft()
        if cur == goal:
            break
        y, x = cur
        for dy, dx in ((0, 1), (0, -1), (-1, 0), (1, 0)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W and grid[ny, nx] == 0 \
                    and (ny, nx) not in prev:
                prev[(ny, nx)] = cur
                q.append((ny, nx))
    if goal not in prev:
        return None
    cells = [goal]
    while prev[cells[-1]] is not None:
        cells.append(prev[cells[-1]])
    return cells[::-1]
