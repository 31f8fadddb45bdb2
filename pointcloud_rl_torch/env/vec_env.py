# Copy of pointcloud_rl_tpu/env/vec_env.py for the PyTorch port (that package's env imports JAX).
"""Vectorized environments: in-process and subprocess workers.

Parity target: reference ``pyrl/env/vec_env.py`` + ``pyrl/utils/meta/
parallel_runner.py`` — N env workers stepped in parallel, a
``UnifiedVectorEnvAPI`` wrapper that tracks recent_obs / recent_actions /
prev_actions / episode_dones, auto-resets done envs, and emits the 9-key
transition dict {obs, next_obs, prev_actions, actions, rewards, dones,
episode_dones, infos(worker-lite), worker_indices} consumed by the replay.

Transport: worker processes communicate over pipes (obs payloads are small:
point clouds are a few hundred KB per step across all workers).  A
shared-memory fast path can be layered underneath without changing this API.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.tree_ops import tree_concat, tree_expand, tree_map, tree_slice, tree_stack
from .api import Env, true_done
from .spaces import stack_action_space


# ---------------------------------------------------------------- workers
def _worker_loop(env_fn_cfg, worker_seed, conn):
    """Subprocess body: build env, serve commands over the pipe.

    Once a shared-memory buffer is attached, observations are written into
    the worker's slot instead of being pickled through the pipe (the
    reference's BufferAugmentedEnv + SharedDictArray obs plane)."""
    # Graceful-preemption contract: coreutils `timeout` (and most schedulers)
    # signal the whole process GROUP, so workers receive the same SIGTERM as
    # the trainer.  The trainer's trap finishes the cycle and writes a
    # numbered checkpoint — which needs the workers alive for a few more
    # steps; a worker that dies on that TERM instead kills the cycle with
    # EOFError and loses the checkpoint (observed in production chain runs).
    # Workers therefore ignore TERM/INT: the parent owns their lifecycle via
    # the "exit" command, and a hard-killed parent closes the pipe, which
    # lands recv() in EOFError -> clean self-exit below (no orphan risk).
    import signal as _signal

    _signal.signal(_signal.SIGTERM, _signal.SIG_IGN)
    _signal.signal(_signal.SIGINT, _signal.SIG_IGN)
    # Env workers must not oversubscribe BLAS threads.
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    from ..utils.shmem import SharedTreeBuffer
    from .builder import build_env

    env = build_env(env_fn_cfg)
    if worker_seed is not None:
        env.seed(worker_seed)
    buffer, slot = None, 0

    def _ship_obs(obs):
        if buffer is None:
            return obs
        buffer.write(slot, obs)
        return None

    try:
        while True:
            cmd, payload = conn.recv()
            if cmd == "reset":
                conn.send(_ship_obs(env.reset(**(payload or {}))))
            elif cmd == "step":
                obs, reward, done, info = env.step(payload)
                conn.send((_ship_obs(obs), reward, done, info))
            elif cmd == "attach_buffer":
                meta, slot = payload
                buffer = SharedTreeBuffer.attach(meta)
                conn.send(None)
            elif cmd == "call":
                name, args, kwargs = payload
                conn.send(getattr(env, name)(*args, **(kwargs or {})))
            elif cmd == "getattr":
                conn.send(getattr(env, payload))
            elif cmd == "seed":
                env.seed(payload)
                conn.send(None)
            elif cmd == "exit":
                conn.send(None)
                break
    finally:
        if buffer is not None:
            buffer.close()
        env.close()
        conn.close()


def _mp_context():
    """Worker start-method: ``forkserver`` by default (override with
    PCRL_MP_START).  Plain ``fork`` after JAX has spawned XLA threads is a
    documented deadlock hazard; the forkserver process is started before any
    device use and preloads the env package once, so each worker is a cheap
    fork that already has numpy/jax modules mapped copy-on-write."""
    method = os.environ.get("PCRL_MP_START", "forkserver")
    if method == "forkserver":
        # The forkserver bootstrap re-imports __main__; stdin/REPL parents
        # have no importable main module, so fall back to fork there.
        import __main__ as _m

        main_file = getattr(_m, "__file__", None)
        if main_file is None or str(main_file).startswith("<"):
            method = "fork"
    ctx = mp.get_context(method)
    if method == "forkserver":
        try:
            ctx.set_forkserver_preload(["pointcloud_rl_torch.env"])
        except (ValueError, RuntimeError):
            pass
    return ctx


class EnvWorker:
    """Handle to one subprocess env (reference Worker, parallel_runner.py:14)."""

    def __init__(self, env_cfg, seed=None, ctx=None):
        ctx = ctx or _mp_context()
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_worker_loop, args=(env_cfg, seed, child), daemon=True)
        self.proc.start()
        child.close()
        self._pending = False

    def send(self, cmd, payload=None):
        assert not self._pending, "Worker already has a pending command"
        self.conn.send((cmd, payload))
        self._pending = True

    def recv(self):
        assert self._pending, "No pending command"
        self._pending = False
        return self.conn.recv()

    def ask(self, cmd, payload=None):
        self.send(cmd, payload)
        return self.recv()

    def close(self, timeout: float = 5.0):
        """Ask the worker to exit.  One that does not within ``timeout`` (say,
        wedged in ``env.step``) gets SIGTERM, which workers ignore, and then
        SIGKILL, each followed by a bounded join, so shutdown never hangs."""
        try:
            if self.proc.is_alive() and not self._pending:
                self.conn.send(("exit", None))
                if self.conn.poll(timeout):
                    self.conn.recv()
                self.proc.join(timeout=timeout)
        except (BrokenPipeError, EOFError, ConnectionResetError):
            pass
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=1)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=timeout)


# ------------------------------------------------------------- vec bases
class VectorEnvBase(Env):
    num_envs: int

    def reset(self, idx=None, **kwargs):
        raise NotImplementedError

    def step(self, actions, idx=None):
        raise NotImplementedError


class SingleEnv2VecEnv(VectorEnvBase):
    """In-process single env exposed as a 1-env vec env
    (reference vec_env.py:349)."""

    def __init__(self, env_cfgs, seed=None):
        from .builder import build_env

        assert len(env_cfgs) == 1
        self._env = build_env(env_cfgs[0])
        if seed is not None:
            self._env.seed(seed)
        self.num_envs = 1
        self.single_action_space = self._env.action_space
        self.action_space = stack_action_space(self._env.action_space, 1)
        self.is_discrete = getattr(self._env, "is_discrete", False)
        self.reward_scale = getattr(self._env, "reward_scale", 1.0)

    def reset(self, idx=None, **kwargs):
        return tree_expand(self._env.reset(**kwargs), 0)

    def step(self, actions, idx=None):
        obs, r, d, info = self._env.step(actions[0])
        return (
            tree_expand(obs, 0),
            np.array([[np.float32(r)]]),
            np.array([[bool(d)]]),
            [info],
        )

    # async API parity (in-process: the step runs eagerly)
    def step_async(self, actions, idx=None) -> None:
        self._step_result = self.step(actions, idx=idx)

    def step_poll(self, idx=None) -> bool:
        return getattr(self, "_step_result", None) is not None

    def step_wait(self, idx=None):
        res, self._step_result = self._step_result, None
        return res

    def step_random_actions(self, num):
        out = self._env.step_random_actions(num)
        return out

    def render(self, mode="rgb_array", idx=None, **kwargs):
        return self._env.render(mode, **kwargs)

    def get_env_state(self):
        return [self._env.get_env_state()]

    def call(self, name, *args, idx=None, **kwargs):
        return [getattr(self._env, name)(*args, **kwargs)]

    def get_attr(self, name, idx=None):
        return getattr(self._env, name)

    def seed(self, seed):
        self._env.seed(seed)

    def close(self):
        self._env.close()


class VectorEnv(VectorEnvBase):
    """N subprocess envs (reference vec_env.py:412).

    With use_shared_memory (default), observations travel through a
    SharedTreeBuffer slot per worker instead of the pipe; the buffer is
    created lazily from the first reset's observation."""

    def __init__(self, env_cfgs, seeds: Optional[List[int]] = None, use_shared_memory: bool = True):
        self.num_envs = len(env_cfgs)
        seeds = seeds or [None] * self.num_envs
        ctx = _mp_context()
        self.workers = [EnvWorker(cfg, seed, ctx) for cfg, seed in zip(env_cfgs, seeds)]
        self.single_action_space = self.workers[0].ask("getattr", "action_space")
        self.action_space = stack_action_space(self.single_action_space, self.num_envs)
        self.is_discrete = self.workers[0].ask("getattr", "is_discrete")
        self.reward_scale = self.workers[0].ask("getattr", "reward_scale")
        self.use_shared_memory = use_shared_memory
        self._shm = None

    def _idx(self, idx):
        return np.arange(self.num_envs) if idx is None else np.asarray(idx)

    def _setup_buffer(self, example_obs) -> None:
        from ..utils.shmem import SharedTreeBuffer

        self._shm = SharedTreeBuffer.create(example_obs, self.num_envs)
        for i, w in enumerate(self.workers):
            w.ask("attach_buffer", (self._shm.meta, i))

    def _obs_of(self, payload, i):
        return self._shm.read(int(i)) if payload is None else payload

    def reset(self, idx=None, level=None, **kwargs):
        idx = self._idx(idx)
        for rank, i in enumerate(idx):
            kw = dict(kwargs)
            if level is not None:
                kw["level"] = level[rank] if isinstance(level, (list, np.ndarray)) else level
            self.workers[i].send("reset", kw)
        obs = [self._obs_of(self.workers[i].recv(), i) for i in idx]
        if self.use_shared_memory and self._shm is None:
            self._setup_buffer(obs[0])
        return tree_stack(obs, 0)

    def step(self, actions, idx=None):
        self.step_async(actions, idx)
        return self.step_wait(idx)

    def step_async(self, actions, idx=None) -> None:
        """Dispatch step commands without waiting (reference vec_env
        partial/async stepping, rollout.py:144-148): workers simulate while
        the caller overlaps policy inference for other env groups."""
        idx = self._idx(idx)
        for rank, i in enumerate(idx):
            self.workers[i].send("step", actions[rank])

    def step_poll(self, idx=None) -> bool:
        """True when every worker in ``idx`` has its step result ready."""
        idx = self._idx(idx)
        return all(self.workers[i].conn.poll() for i in idx)

    def step_wait(self, idx=None):
        idx = self._idx(idx)
        results = [self.workers[i].recv() for i in idx]
        if self._shm is not None and all(r[0] is None for r in results):
            obs = self._shm.read_batch(idx)  # one stacked copy per leaf
        else:
            obs = tree_stack([self._obs_of(r[0], i) for r, i in zip(results, idx)], 0)
        rewards = np.array([[np.float32(r[1])] for r in results])
        dones = np.array([[bool(r[2])] for r in results])
        infos = [r[3] for r in results]
        return obs, rewards, dones, infos

    def step_random_actions(self, num):
        from ..utils.stats import split_num

        counts = split_num(num, self.num_envs)
        for i, n in enumerate(counts):
            if n > 0:
                self.workers[i].send("call", ("step_random_actions", (n,), {}))
        outs = []
        for i, n in enumerate(counts):
            if n > 0:
                out = self.workers[i].recv()
                out["worker_indices"] = np.full_like(out["worker_indices"], i)
                outs.append(out)
        return tree_concat(outs, 0)

    def render(self, mode="rgb_array", idx=None, **kwargs):
        idx = self._idx(idx)
        for i in idx:
            self.workers[i].send("call", ("render", (mode,), kwargs))
        return [self.workers[i].recv() for i in idx]

    def get_env_state(self):
        for w in self.workers:
            w.send("call", ("get_env_state", (), {}))
        return [w.recv() for w in self.workers]

    def call(self, name, *args, idx=None, **kwargs):
        idx = self._idx(idx)
        for i in idx:
            self.workers[i].send("call", (name, args, kwargs))
        return [self.workers[i].recv() for i in idx]

    def get_attr(self, name, idx=None):
        return self.workers[self._idx(idx)[0]].ask("getattr", name)

    def seed(self, seed):
        for i, w in enumerate(self.workers):
            w.ask("seed", seed + i)

    def close(self):
        for w in self.workers:
            w.close()
        if self._shm is not None:
            self._shm.close()
            self._shm = None


class ThreadBasedVectorEnv(VectorEnvBase):
    """N in-process envs stepped by a thread pool.

    Parity target: reference ``SapienThreadEnv`` (vec_env.py:822-918) — an
    in-process vectorized env whose per-env step_async/wait runs on threads,
    for simulators that release the GIL during stepping (SAPIEN's
    step_async there; MuJoCo's ``mj_step`` here).  Redesigned for this
    stack: instead of SAPIEN's internal sim/render thread stages and torch
    buffer planes, each env steps inside a ``ThreadPoolExecutor`` future and
    ships numpy obs directly — no pipes, no shared-memory plane, no pickling
    (the win over subprocess workers on a single-core host is the removed
    IPC; the loss is GIL contention for pure-Python envs).
    """

    def __init__(self, env_cfgs, seeds: Optional[List[int]] = None):
        from concurrent.futures import ThreadPoolExecutor

        from .builder import build_env

        self.num_envs = len(env_cfgs)
        # ONE dedicated thread per env, and every interaction (including
        # construction) runs on that thread: GL render contexts (EGL in
        # dm_control, Vulkan in SAPIEN) are thread-affine — a context made
        # current on one thread cannot be used from another.
        self._pools = [ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"pcrl-env{i}")
                       for i in range(self.num_envs)]
        self.envs = [p.submit(build_env, cfg).result()
                     for p, cfg in zip(self._pools, env_cfgs)]
        seeds = seeds or [None] * self.num_envs
        for p, env, s in zip(self._pools, self.envs, seeds):
            if s is not None:
                p.submit(env.seed, s).result()
        self.single_action_space = self.envs[0].action_space
        self.action_space = stack_action_space(self.single_action_space, self.num_envs)
        self.is_discrete = getattr(self.envs[0], "is_discrete", False)
        self.reward_scale = getattr(self.envs[0], "reward_scale", 1.0)
        self._futures: Dict[int, Any] = {}

    def _idx(self, idx):
        return np.arange(self.num_envs) if idx is None else np.asarray(idx)

    def _on(self, i, fn, *args, **kwargs):
        return self._pools[int(i)].submit(fn, *args, **kwargs)

    def reset(self, idx=None, level=None, **kwargs):
        idx = self._idx(idx)
        futures = []
        for rank, i in enumerate(idx):
            kw = dict(kwargs)
            if level is not None:
                kw["level"] = level[rank] if isinstance(level, (list, np.ndarray)) else level
            futures.append(self._on(i, self.envs[i].reset, **kw))
        return tree_stack([f.result() for f in futures], 0)

    def step(self, actions, idx=None):
        self.step_async(actions, idx)
        return self.step_wait(idx)

    def step_async(self, actions, idx=None) -> None:
        idx = self._idx(idx)
        for rank, i in enumerate(idx):
            assert int(i) not in self._futures, f"env {i} already stepping"
            self._futures[int(i)] = self._on(i, self.envs[i].step, actions[rank])

    def step_poll(self, idx=None) -> bool:
        idx = self._idx(idx)
        return all(self._futures[int(i)].done() for i in idx)

    def step_wait(self, idx=None):
        idx = self._idx(idx)
        results = [self._futures.pop(int(i)).result() for i in idx]
        obs = tree_stack([r[0] for r in results], 0)
        rewards = np.array([[np.float32(r[1])] for r in results])
        dones = np.array([[bool(r[2])] for r in results])
        infos = [r[3] for r in results]
        return obs, rewards, dones, infos

    def step_random_actions(self, num):
        from ..utils.stats import split_num

        counts = split_num(num, self.num_envs)
        futures = [(i, self._on(i, self.envs[i].step_random_actions, n))
                   for i, n in enumerate(counts) if n > 0]
        outs = []
        for i, f in futures:
            out = f.result()
            out["worker_indices"] = np.full_like(out["worker_indices"], i)
            outs.append(out)
        return tree_concat(outs, 0)

    def render(self, mode="rgb_array", idx=None, **kwargs):
        return [self._on(i, self.envs[i].render, mode, **kwargs).result() for i in self._idx(idx)]

    def get_env_state(self):
        return [self._on(i, e.get_env_state).result() for i, e in enumerate(self.envs)]

    def call(self, name, *args, idx=None, **kwargs):
        return [self._on(i, getattr(self.envs[i], name), *args, **kwargs).result()
                for i in self._idx(idx)]

    def get_attr(self, name, idx=None):
        return getattr(self.envs[self._idx(idx)[0]], name)

    def seed(self, seed):
        for i, env in enumerate(self.envs):
            self._on(i, env.seed, seed + i).result()

    def close(self):
        for i, env in enumerate(self.envs):
            self._on(i, env.close)
        for p in self._pools:
            p.shutdown(wait=True)


class UnifiedVectorEnvAPI(VectorEnvBase):
    """Caches recent obs/actions, auto-resets, builds transition dicts
    (reference vec_env.py:38-246)."""

    def __init__(self, vec_env: VectorEnvBase):
        self.vec_env = vec_env
        self.num_envs = vec_env.num_envs
        self.action_space = vec_env.action_space
        self.single_action_space = vec_env.single_action_space
        self.is_discrete = vec_env.is_discrete
        self.reward_scale = getattr(vec_env, "reward_scale", 1.0)

        self.recent_obs = None
        self.recent_actions = None
        self.prev_actions = None
        self.episode_dones = np.ones((self.num_envs, 1), bool)
        self._action_dim = None
        self._pending: Dict[tuple, dict] = {}  # step_dict_async bookkeeping

    def _zero_actions(self) -> np.ndarray:
        if self.is_discrete:
            return np.zeros((self.num_envs, 1), np.int32)
        sample = np.asarray(self.vec_env.single_action_space.sample())
        return np.zeros((self.num_envs,) + sample.shape, np.float32)

    def reset(self, idx=None, **kwargs):
        obs = self.vec_env.reset(idx=idx, **kwargs)
        if idx is None or self.recent_obs is None:
            # Own a WRITABLE persistent buffer: device-fused obs
            # (server_env._fuse) arrive as read-only zero-copy host views,
            # and step_dict_wait/partial reset write into recent_obs in place.
            self.recent_obs = tree_map(
                lambda x: np.array(x) if isinstance(x, np.ndarray) and not x.flags.writeable else x,
                obs,
            )
            self.recent_actions = self._zero_actions()
            self.prev_actions = self._zero_actions()
            self.episode_dones = np.zeros((self.num_envs, 1), bool)
        else:
            idx = np.asarray(idx)
            tree_map(lambda dst, src: dst.__setitem__(idx, src), self.recent_obs, obs)
            self.recent_actions[idx] = 0
            self.prev_actions[idx] = 0
            self.episode_dones[idx] = False
        return self.recent_obs

    def step(self, actions, idx=None):
        assert idx is None, "Partial stepping handled via step_dict(idx=...)"
        return self.vec_env.step(actions)

    def step_dict(self, actions, restart: bool = True, idx=None) -> Dict[str, Any]:
        """One synchronized vec step -> 9-key transition dict
        (reference vec_env.py:194-226).  ``idx`` selects an env subset
        (partial stepping)."""
        self.step_dict_async(actions, idx=idx)
        return self.step_dict_wait(idx=idx, restart=restart)

    def step_dict_async(self, actions, idx=None) -> None:
        """Dispatch steps for an env group without waiting; pair with
        :meth:`step_dict_wait`.  While the group simulates, the caller can
        run policy inference for other groups (the reference's
        step_async/partial_forward overlap, rollout.py:144-181)."""
        idx = np.arange(self.num_envs) if idx is None else np.asarray(idx)
        key = tuple(int(i) for i in idx)
        assert key not in self._pending, f"Group {key} already has a pending step"
        actions = np.asarray(actions)
        # x[idx] fancy-indexing already materializes a copy (idx is an index
        # array), so the snapshot survives recent_obs/recent_actions mutation
        # without a second .copy() pass — this sits on the per-step hot path.
        self._pending[key] = dict(
            obs=tree_map(lambda x: x[idx], self.recent_obs),
            prev_actions=self.recent_actions[idx],
            actions=actions.copy(),
        )
        self.prev_actions[idx] = self.recent_actions[idx]
        self.recent_actions[idx] = actions
        self.vec_env.step_async(actions, idx=idx)

    def step_dict_poll(self, idx=None) -> bool:
        return self.vec_env.step_poll(idx=np.arange(self.num_envs) if idx is None else np.asarray(idx))

    def step_dict_wait(self, idx=None, restart: bool = True) -> Dict[str, Any]:
        idx = np.arange(self.num_envs) if idx is None else np.asarray(idx)
        key = tuple(int(i) for i in idx)
        pend = self._pending.pop(key)
        next_obs, rewards, dones, infos = self.vec_env.step_wait(idx)
        self.episode_dones[idx] = dones

        ret = dict(
            obs=pend["obs"],
            next_obs=next_obs,
            prev_actions=pend["prev_actions"],
            actions=pend["actions"],
            rewards=np.float32(rewards),
            dones=np.asarray([[bool(true_done(dones[r, 0], infos[r]))] for r in range(len(idx))]),
            episode_dones=dones.copy(),
            infos=_stack_infos(infos),
            worker_indices=idx.astype(np.int32)[:, None],
        )
        # COPY the fresh next_obs into the persistent recent_obs buffers
        # (never alias): the auto-reset below and later steps mutate
        # recent_obs in place and must not corrupt the returned transition.
        tree_map(lambda dst, src: dst.__setitem__(idx, src), self.recent_obs, next_obs)
        done_idx = idx[np.nonzero(dones[:, 0])[0]]
        if len(done_idx) and restart:
            self.reset(idx=done_idx)
        return ret

    def step_random_actions(self, num) -> Dict[str, Any]:
        ret = self.vec_env.step_random_actions(num)
        # After random stepping the cached obs are stale; re-reset all envs.
        self.reset()
        return ret

    def random_actions(self) -> np.ndarray:
        sample = self.vec_env.action_space.sample()
        return np.asarray(sample)

    def render(self, mode="rgb_array", idx=None, **kwargs):
        return self.vec_env.render(mode, idx=idx, **kwargs)

    def get_env_state(self):
        return self.vec_env.get_env_state()

    def call(self, name, *args, idx=None, **kwargs):
        return self.vec_env.call(name, *args, idx=idx, **kwargs)

    def get_attr(self, name, idx=None):
        return self.vec_env.get_attr(name, idx=idx)

    def seed(self, seed):
        self.vec_env.seed(seed)

    def close(self):
        self.vec_env.close()


def _stack_infos(infos: List[dict]) -> Dict[str, np.ndarray]:
    """Stack scalar info entries across workers; drop ragged/object entries."""
    if not infos:
        return {}
    keys = set(infos[0])
    for info in infos[1:]:
        keys &= set(info)
    out = {}
    for k in keys:
        try:
            vals = np.stack([np.asarray(info[k]) for info in infos])
            if vals.dtype != object:
                out[k] = vals.reshape(len(infos), -1)
        except (ValueError, TypeError):
            continue
    return out


def build_vec_env_from_cfgs(env_cfgs, seeds=None, use_subprocess: Optional[bool] = None,
                            backend: Optional[str] = None, device="cuda") -> UnifiedVectorEnvAPI:
    """Pick the vec-env implementation (reference env_utils.py:220-258).

    ``backend``: "subprocess" (default for >1 env), "thread"
    (ThreadBasedVectorEnv — SapienThreadEnv analogue, for GIL-releasing
    sims), or "single" (1 env in-process).

    ``server_obs: True`` in the env cfgs selects the ServerBasedVectorEnv
    analogue (reference vec_env.py:562-742): workers run in
    ``obs_mode="raw"`` (cheap render products) and ONE batched program on
    ``device`` fuses every env's observation to the pointcloud contract
    (env/server_env.py).  ``device`` is used by that path only."""
    server_obs = any(dict(c).get("server_obs", False) for c in env_cfgs)
    if server_obs:
        from .server_env import ServerObsVectorEnv

        inner_cfgs = []
        num_frames = 1
        for c in env_cfgs:
            c = dict(c)
            c.pop("server_obs", None)
            if c.get("obs_mode", "state") != "pointcloud":
                raise ValueError("server_obs fuses the pointcloud contract only")
            c["obs_mode"] = "raw"
            num_frames = int(c.get("stack_frame", 1))
            inner_cfgs.append(c)
        base = build_vec_env_from_cfgs(inner_cfgs, seeds=seeds, use_subprocess=use_subprocess, backend=backend)
        seed0 = seeds[0] if seeds else None
        return UnifiedVectorEnvAPI(ServerObsVectorEnv(base.vec_env, num_frames=num_frames, seed=seed0,
                                                      device=device))
    if backend is None:
        if use_subprocess is None:
            use_subprocess = len(env_cfgs) > 1
        backend = "subprocess" if (len(env_cfgs) > 1 or use_subprocess) else "single"
    if backend == "single":
        assert len(env_cfgs) == 1, "backend='single' requires exactly one env cfg"
        base = SingleEnv2VecEnv(env_cfgs, seed=seeds[0] if seeds else None)
    elif backend == "thread":
        base = ThreadBasedVectorEnv(env_cfgs, seeds=seeds)
    elif backend == "subprocess":
        base = VectorEnv(env_cfgs, seeds=seeds)
    else:
        raise ValueError(f"unknown vec-env backend {backend!r}")
    return UnifiedVectorEnvAPI(base)
