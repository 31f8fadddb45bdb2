"""The walker stand-in renders what a plain ray cast over every pixel renders.

``WalkerRawStandIn`` casts its spheres only inside the rectangle that their
silhouettes can cover and works out the fixed ground once; here every frame
of a seeded episode, with actions that swing the body hard, is held bit for
bit to the plain cast that ``chip_smoke.py``'s stand-in makes."""

import numpy as np
import pytest
import tiny  # noqa: F401  (puts the benchmark and the repo on the path)

from pcbench.standins import WalkerRawStandIn


def plain_obs(env: WalkerRawStandIn) -> dict:
    """Every pixel cast against the ground and each sphere in turn."""
    cam = np.array([env.x, -2.2, 1.2])
    d = env._dirs
    depth = np.full(len(d), 10.0)
    hit = np.full(len(d), -1)
    down = d[:, 2] < 0
    t = np.where(down, -cam[2] / np.where(down, d[:, 2], -1.0), np.inf)
    depth = np.where(down, t, depth)
    hit[down] = 0
    centres = np.stack([env.x + env.SPHERES[:, 0] + env.pose[:, 0], np.zeros(8),
                        env.SPHERES[:, 1] + env.pose[:, 1]], -1)
    a = (d * d).sum(-1)
    for i, (c, r) in enumerate(zip(centres, env.SPHERES[:, 2])):
        oc = cam - c
        b = d @ oc
        disc = b * b - a * (oc @ oc - r * r)
        tt = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        near = (disc > 0) & (tt > 0) & (tt < depth)
        depth[near], hit[near] = tt[near], i + 1
    h, w = int(env.image_size[1]), int(env.image_size[0])
    depth, hit = depth.reshape(h, w).astype(np.float32), hit.reshape(h, w)
    world = cam + d * depth.reshape(-1, 1)
    checker = ((np.floor(world[:, 0] * 4) + np.floor(world[:, 1] * 4)) % 2).reshape(h, w)
    rgb = np.empty((h, w, 3), np.uint8)
    rgb[:] = env.SKY
    ground = hit == 0
    rgb[ground] = np.where(checker[ground, None] > 0, env.GROUND[0], env.GROUND[1])
    body = hit > 0
    rgb[body] = np.stack([200 - 10 * hit[body], 120 + 5 * hit[body], 60 + 0 * hit[body]], -1)
    return {"depth": depth[None], "rgb": np.ascontiguousarray(rgb.transpose(2, 0, 1)), "body_pixels": int(body.sum())}


@pytest.mark.parametrize("seed", [0, 2900000011])
def test_walker_standin_renders_the_plain_cast(seed):
    env = WalkerRawStandIn()
    env.seed(seed)
    obs = env.reset()
    actions = np.random.RandomState(seed % 2**32)
    bodies = 0
    for step in range(300):
        want = plain_obs(env)
        for k in ("depth", "rgb"):
            assert obs[k].dtype == want[k].dtype and obs[k].shape == want[k].shape, k
            assert np.array_equal(obs[k], want[k]), (k, step)
        bodies += want["body_pixels"] > 0
        obs = env.step(actions.uniform(-1, 1, 6) * (4.0 if step % 25 == 0 else 1.0))[0]
    assert bodies == 300
