"""PNG asset overlay: the sprite atlas and backgrounds from a reference
`assets/` tree (the port's copy of procgen2_tpu/render/png_assets.py).

The port ships deterministic procedural art (`render/atlas.py`); the
reference's third-party PNGs are not redistributed. This module overlays
real PNG art from a *user-supplied* copy of the reference's `assets/`
directory onto the same sprite registry, so that

* rendered frames can be pixel-compared against recorded reference frames
  (`python -m procgen2_tpu_torch.tools.difference --fixture fx.npz
  --assets DIR`), and
* users migrating from the reference keep its exact look.

Every mapping entry cites the reference load site. The reference loads PNGs
through `Asset_Texture::load` (games/maze/common_assets.cpp:3-16) into an
`Asset_Manager` keyed by path (games/maze/asset_manager.h:7-37); here the
PNGs are decoded once (Pillow), resampled to the atlas sprite size, and
installed as registry overrides, after which `build_atlas` /
`build_pixel_bank` / `build_backgrounds` pick them up on their next
(cache-cleared) call.

Install *before* constructing environments. `install` and `uninstall`
clear every cache built from the registry, the games' device tensors
included, so an env made afterwards renders the new art; but an object
that already holds those tensors keeps them: a rollout graph captured
before the call (`dist.rollout`) replays the old art.

    from procgen2_tpu_torch.render import png_assets
    png_assets.install("/path/to/Procgen2/assets")
    env = procgen2_tpu_torch.make("coinrun")
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import atlas
from .atlas import S

# ---------------------------------------------------------------------------
# name -> reference-assets relative path
# ---------------------------------------------------------------------------

# Reference name spellings (games/coinrun/tilemap.h:29-31,
# games/coinrun/common_systems.h:62, games/climber/common_systems.h:61).
_REF_WALL_THEMES = {t: t.capitalize() for t in atlas.WALL_THEMES}
_REF_ENEMIES = {
    "slime_block": "slimeBlock", "slime_purple": "slimePurple",
    "slime_blue": "slimeBlue", "slime_green": "slimeGreen",
    "mouse_w": "mouse", "snail": "snail", "ladybug": "ladybug",
    "worm_green": "wormGreen", "worm_pink": "wormPink",
}
_REF_CRATES = {
    "crate": "boxCrate", "crate_double": "boxCrate_double",
    "crate_single": "boxCrate_single", "crate_warning": "boxCrate_warning",
}


def default_mapping() -> Dict[str, str]:
    """Registry sprite name -> path relative to the reference assets/ root."""
    m: Dict[str, str] = {
        # maze (games/maze/tilemap.cpp:12-15, common_systems.cpp:66)
        "maze_wall": "kenney/Ground/Sand/sandCenter.png",
        "cheese": "misc_assets/cheese.png",
        "mouse": "kenney/Enemies/mouse_move.png",
        # coinrun shared items (games/coinrun/tilemap.cpp:16-36,
        # common_systems.cpp:281)
        "lava_top": "kenney/Tiles/lavaTop_low.png",
        "lava_mid": "kenney/Tiles/lava.png",
        "saw": "kenney/Enemies/sawHalf.png",
        "saw_move": "kenney/Enemies/sawHalf_move.png",
        "coin": "kenney/Items/coinGold.png",
        "particle_circle": "misc_assets/iconCircle_white.png",
        # chaser (games/chaser/tilemap.cpp:10-16, common_systems.cpp:106-118,
        # 302)
        "stone_wall": "misc_assets/tileStone_slope.png",
        "chaser_point": "custom/chaser_point.png",
        "egg_spikey": "misc_assets/enemySpikey_1b.png",
        "walker_flee": "misc_assets/enemyWalking_1b.png",
        "floater": "misc_assets/enemyFloating_1b.png",
        # climber (games/climber/tilemap.cpp:21-25)
        "crystal": "misc_assets/yellowCrystal.png",
        "swimmer": "platformer/enemySwimming_1.png",
        "swimmer_move": "platformer/enemySwimming_2.png",
        # jumper (games/jumper/tilemap.cpp + jumper.cpp:473-509,
        # common_systems.cpp)
        "carrot": "misc_assets/carrot.png",
        "spikeman": "misc_assets/spikeMan_stand.png",
        "compass_circle": "custom/jumper_compass_circle.png",
        # caveflyer (games/caveflyer/tilemap.cpp:10-19,
        # common_systems.cpp:77-88)
        "cave_wall": "misc_assets/groundA.png",
        "ufo_green": "misc_assets/ufoGreen2.png",
        "ufo_red": "misc_assets/ufoRed2.png",
        "meteor": "misc_assets/meteorBrown_big1.png",
        "enemy_ship": "misc_assets/enemyShipBlue4.png",
        "laser": "misc_assets/laserBlue02.png",
        "ship_red": "misc_assets/playerShip1_red.png",
        "smoke": "misc_assets/towerDefense_tile295.png",
        # bossfight (games/bossfight/common_systems.cpp:48-72,
        # bossfight.cpp:70-78)
        "shield": "misc_assets/shield2.png",
    }
    # wall tiles: reference maps wall_top <- "<t>Mid.png" and
    # wall_mid <- "<t>Center.png" (games/coinrun/tilemap.cpp:11-12)
    for t, T in _REF_WALL_THEMES.items():
        m[f"wall_top_{t}"] = f"kenney/Ground/{T}/{t}Mid.png"
        m[f"wall_mid_{t}"] = f"kenney/Ground/{T}/{t}Center.png"
    # crates (games/coinrun/tilemap.cpp:24)
    for ours, ref in _REF_CRATES.items():
        m[ours] = f"kenney/Tiles/{ref}.png"
    # walking enemies + _move frames (games/coinrun/tilemap.cpp:28-29)
    for ours, ref in _REF_ENEMIES.items():
        m[ours] = f"kenney/Enemies/{ref}.png"
        m[f"{ours}_move"] = f"kenney/Enemies/{ref}_move.png"
    # coinrun agent poses (games/coinrun/common_systems.cpp:114-117)
    for t in atlas.AGENT_THEMES:
        T = t.capitalize()
        for kind in ("stand", "jump", "walk1", "walk2"):
            m[f"alien_{t}_{kind}"] = (
                f"kenney/Players/128x256/{T}/alien{T}_{kind}.png"
            )
    # climber agent poses: "jump" uses walk4 (games/climber/
    # common_systems.cpp:177-180)
    for t in atlas.CLIMBER_AGENT_THEMES:
        T = t.capitalize()
        ref_kind = {"stand": "stand", "jump": "walk4",
                    "walk1": "walk1", "walk2": "walk2"}
        for kind, rk in ref_kind.items():
            m[f"climber_{t}_{kind}"] = f"platformer/player{T}_{rk}.png"
    # climber tiles (games/climber/tilemap.cpp:10-18)
    climber_tiles = {
        ("blue", "top"): "tileBlue_05.png", ("blue", "mid"): "tileBlue_08.png",
        ("green", "top"): "tileGreen_05.png", ("green", "mid"): "tileGreen_08.png",
        ("yellow", "top"): "tileYellow_06.png", ("yellow", "mid"): "tileYellow_09.png",
        ("brown", "top"): "tileBrown_06.png", ("brown", "mid"): "tileBrown_09.png",
    }
    for (t, part), fn in climber_tiles.items():
        m[f"ctile_{part}_{t}"] = f"platformer/{fn}"
    # chaser flyer frames (games/chaser/common_systems.cpp:111-114)
    for i in range(3):
        m[f"flyer{i}"] = f"misc_assets/enemyFlying_{i + 1}.png"
    # jumper bunny: "stand" uses bunny2_ready (games/jumper/
    # common_systems.cpp analog of coinrun's pose load)
    bunny = {"stand": "ready", "jump": "jump", "walk1": "walk1", "walk2": "walk2"}
    for kind, rk in bunny.items():
        m[f"bunny_{kind}"] = f"misc_assets/bunny2_{rk}.png"
    # explosions (games/caveflyer/common_systems.cpp:84: explosion{1..5})
    for i in range(5):
        m[f"explosion{i}"] = f"misc_assets/explosion{i + 1}.png"
    # bossfight ships/bolts (games/bossfight/common_systems.cpp:452-469,
    # 723-737)
    boss = {"black": "enemyShipBlack1", "blue": "enemyShipBlue2",
            "green": "enemyShipGreen3", "red": "enemyShipRed4"}
    pship = {"blue": "playerShip1_blue", "green": "playerShip1_green",
             "orange": "playerShip2_orange", "red": "playerShip3_red"}
    bolt = {"green": "laserGreen14", "red": "laserRed11", "blue": "laserBlue09"}
    for k, v in boss.items():
        m[f"boss_ship_{k}"] = f"misc_assets/{v}.png"
    for k, v in pship.items():
        m[f"pship_{k}"] = f"misc_assets/{v}.png"
    for k, v in bolt.items():
        m[f"bolt_{k}"] = f"misc_assets/{v}.png"
    # barriers (games/bossfight/bossfight.cpp:70-74: spaceMeteors_001..004;
    # the atlas keeps 3 variants)
    for i in range(3):
        m[f"barrier{i}"] = f"misc_assets/spaceMeteors_00{i + 1}.png"
    return m


# Background lists per atlas "kind" (atlas.build_backgrounds):
#   topdown — maze/chaser (games/maze/maze.cpp:62-72)
#   sky     — coinrun/jumper/climber (games/coinrun/coinrun.cpp:60-110)
#   space   — caveflyer/bossfight (games/caveflyer/caveflyer.cpp:59-72)
BACKGROUND_PATHS: Dict[str, Sequence[str]] = {
    "topdown": ["topdown_backgrounds/floortiles.png"] + [
        f"topdown_backgrounds/backgrounddetailed{i}.png" for i in range(1, 9)
    ],
    "sky": [
        f"platform_backgrounds/{n}.png" for n in (
            "alien_bg", "another_world_bg", "back_cave", "caverns",
            "cyberpunk_bg", "parallax_forest", "scifi_bg", "scifi2_bg",
            "living_tissue_bg", "airadventurelevel1", "airadventurelevel2",
            "airadventurelevel3", "airadventurelevel4", "cave_background",
            "blue_desert", "blue_grass", "blue_land", "blue_shroom",
            "colored_desert", "colored_grass", "colored_land",
            "colored_shroom", "landscape1", "landscape2", "landscape3",
            "landscape4", "battleback1", "battleback2", "battleback3",
            "battleback4", "battleback5", "battleback6", "battleback7",
            "battleback8", "battleback9", "battleback10", "sunrise",
        )
    ] + [
        f"platform_backgrounds_2/{n}{i}.png"
        for n in ("beach", "fantasy", "candy") for i in range(1, 5)
    ],
    "space": [
        f"space_backgrounds/{n}.png" for n in (
            "deep_space_01", "spacegen_01", "milky_way_01",
            "ez_space_lite_01", "meyespace_v1_01", "eye_nebula_01",
            "deep_sky_01", "space_nebula_01", "Background-1", "Background-2",
            "Background-3", "Background-4", "parallax-space-backgound",
        )
    ],
}


# ---------------------------------------------------------------------------
# Decoding / installation
# ---------------------------------------------------------------------------

def load_png(path: str, size: int = S, square_crop: bool = False) -> np.ndarray:
    """Decode a PNG and resample to `size` x `size`, float32 RGBA in [0, 1].

    Resampling is area-averaging (PIL BOX): the reference blits full-res
    textures through SDL's software scaler at draw time; pre-filtering to
    the atlas resolution is the batched equivalent.

    square_crop: take the LEFT square of a non-square image before
    resampling. Every reference bg draw scales the texture by
    64*unit_to_pixels/height (e.g. maze.cpp:408) or the screen-height
    equivalent (bossfight.cpp:418), so the visible world only ever shows
    the left height x height region of wide textures (the x offset is
    `-offset * (aspect - 1)` PIXELS — sub-pixel); squashing the full
    width in was a measured ~20-46/255 mean frame error on bossfight's
    480x270 space backgrounds.
    """
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGBA")
        if square_crop and im.width != im.height:
            side = min(im.width, im.height)
            im = im.crop((0, 0, side, side))
        im = im.resize((size, size), Image.BOX)
        arr = np.asarray(im, np.float32) / 255.0
    return arr


_ORIGINALS: Dict[str, object] = {}
_INSTALLED: List[str] = []
_SOURCE_PATHS: Dict[str, str] = {}


def source_path(name: str) -> Optional[str]:
    """Decoded-PNG source of an installed overlay sprite, or None.

    Lets fixed-size screen-space art (jumper's 60 px compass) re-decode
    at its DISPLAY resolution instead of upsampling the S x S atlas
    entry — the atlas detour measured ~14/255 mean frame error against
    the executed reference's native-resolution blit."""
    return _SOURCE_PATHS.get(name)


def _clear_caches():
    """Drop every cache whose value derives from the registry or the
    backgrounds: the atlas's `build_*` caches, and every `lru_cache` defined in a
    loaded game module (the packed atlases, stamp banks, scene banks and
    the tensors made from them on each device, jumper's compass). The
    kernel builds and the caches keyed by content (`phases.
    tile_phase_bank`'s, `utils.consts.const`) stay: a new bank has new
    content, hence a new key."""
    atlas.build_atlas.cache_clear()
    atlas.build_backgrounds.cache_clear()
    atlas.build_pixel_bank.cache_clear()
    for name, mod in list(sys.modules.items()):
        if name.startswith("procgen2_tpu_torch.games.") and mod is not None:
            for attr in vars(mod).values():
                if (callable(attr) and hasattr(attr, "cache_clear")
                        and getattr(attr, "__module__", None) == name):
                    attr.cache_clear()


def install(assets_dir: str, mapping: Optional[Dict[str, str]] = None,
            strict: bool = False, backgrounds: bool = True) -> List[str]:
    """Overlay PNGs from `assets_dir` (a copy of the reference assets/ tree).

    Missing files are skipped (the procedural art stays) unless `strict`.
    Returns the list of overlaid sprite names. Idempotent: re-installing
    replaces previous overlays.
    """
    mapping = default_mapping() if mapping is None else mapping
    installed = []
    for name, rel in mapping.items():
        if name not in atlas._REGISTRY:
            if strict:
                raise KeyError(f"mapping names unknown sprite {name!r}")
            continue
        path = os.path.join(assets_dir, rel)
        if not os.path.exists(path):
            if strict:
                raise FileNotFoundError(path)
            continue
        if name not in _ORIGINALS:
            _ORIGINALS[name] = atlas._REGISTRY[name]
        img = load_png(path)
        atlas._REGISTRY[name] = (lambda im=img: im)
        _SOURCE_PATHS[name] = path
        installed.append(name)

    if backgrounds:
        for kind, rels in BACKGROUND_PATHS.items():
            imgs = []
            for rel in rels:
                path = os.path.join(assets_dir, rel)
                if not os.path.exists(path):
                    if strict:
                        raise FileNotFoundError(path)
                    continue
                rgba = load_png(path, size=atlas.BG_SIZE, square_crop=True)
                imgs.append(
                    np.clip(np.round(rgba[..., :3] * 255), 0, 255).astype(np.uint8)
                )
            if imgs:
                atlas._BG_OVERLAY[kind] = np.stack(imgs)
                installed.append(f"backgrounds:{kind}")

    _INSTALLED[:] = installed
    _clear_caches()
    return installed


def uninstall() -> None:
    """Restore the procedural art."""
    for name, fn in _ORIGINALS.items():
        atlas._REGISTRY[name] = fn
    _ORIGINALS.clear()
    atlas._BG_OVERLAY.clear()
    _INSTALLED[:] = []
    _SOURCE_PATHS.clear()
    _clear_caches()


def installed() -> List[str]:
    return list(_INSTALLED)
