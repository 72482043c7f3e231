"""Lockstep episode runner, port of ``refil_tpu/runners/vector_runner.py``.

B envs are reset together and stepped ``episode_limit`` times in a Python
loop; an env that finishes is frozen (its state, observation and hidden state
stop changing and its outputs are zero). The episode batch follows the
reference exactly:
  * ``filled[0] = 1`` and ``filled[t+1] = alive_t`` (env alive at the start
    of step t), so the terminal observation slot is written;
  * ``terminated[t] = done_t and not episode_limit_t``;
  * ``actions_onehot`` is zero (not one-hot of 0) at never-written steps;
  * every plane has an episode axis of ``episode_limit + 1``.

``heuristic_ai`` (in the config or in ``env_args``) acts with the env's
scripted ally policy (``heuristic_actions``) in place of the selector, as
the JAX runner does; the agent still steps its hidden state. A recording
run (``record=True``) keeps each step's ``render_state`` and render extras
for ``render.py`` in ``last_recording``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..components.action_selectors import SELECTOR_REGISTRY, epsilon_greedy, multinomial
from ..controllers.mac import pi_logits_transform
from ..core.schedules import DecayThenFlatSchedule


def _mask_like(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Zero the batch rows of ``x`` where ``flag`` is False."""
    f = flag.reshape(flag.shape + (1,) * (x.dim() - flag.dim()))
    return torch.where(f, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _to_host(stats):
    """A rollout's device stats as numpy arrays (nested dicts kept)."""
    if isinstance(stats, dict):
        return {k: _to_host(v) for k, v in stats.items()}
    return stats.cpu().numpy()


def _select(flag: torch.Tensor, new, old):
    """Per-env select between two tensors, dicts or tuples (freeze finished envs)."""
    if isinstance(new, dict):
        return {k: _select(flag, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return type(new)(*(_select(flag, n, o) for n, o in zip(new, old)))
    f = flag.reshape(flag.shape + (1,) * (new.dim() - flag.dim()))
    return torch.where(f, new, old)


class VectorRunner:
    def __init__(self, env, mac, args, logger=None, generator=None):
        self.env = env
        self.mac = mac
        self.args = args
        self.logger = logger
        self.generator = generator
        self.batch_size = args.batch_size_run
        info = env.env_info()
        self.episode_limit = info["episode_limit"]
        self.n_agents = info["n_agents"]
        self.n_actions = info["n_actions"]
        self.t_env = 0
        self.schedule = DecayThenFlatSchedule(args.epsilon_start, args.epsilon_finish,
                                              args.epsilon_anneal_time, decay="linear")
        self.epsilon = self.schedule.eval_host(0)
        self.output_type = getattr(args, "agent_output_type", "q")
        self.selector = getattr(args, "action_selector", "epsilon_greedy")
        if self.selector not in SELECTOR_REGISTRY:
            raise ValueError(f"action_selector {self.selector!r} not recognised; known: "
                             f"{sorted(SELECTOR_REGISTRY)}")
        self.train_stats: Dict[str, float] = {}
        self.test_stats: Dict[str, float] = {}
        self.train_returns: List[float] = []
        self.test_returns: List[float] = []
        # cumulative battle stats over the run, train and test episodes
        # (the reference env's lifetime counters)
        self.battles_won = 0
        self.battles_game = 0
        self.timeouts = 0
        self.log_train_stats_t = -1000000
        # the reference ships this knob under env_args (sc2custom.yaml), so
        # both spellings count; FlatBattle has no heuristic_actions, so on the
        # flat env heuristic_ai runs the learner's actions, as in JAX
        self.heuristic = (bool(getattr(args, "heuristic_ai", False))
                          or bool(dict(getattr(args, "env_args", {})).get("heuristic_ai", False))
                          ) and hasattr(env, "heuristic_actions")
        self.mesh = None  # a training run's data mesh (run.py), if any
        self.last_recording: Optional[List[Dict[str, np.ndarray]]] = None

    @torch.no_grad()
    def rollout(self, epsilon: Union[float, torch.Tensor], batch_size: int, test: bool = False,
                env_draws: Optional[dict] = None, index: Optional[int] = None,
                generator: Optional[torch.Generator] = None, record: bool = False,
                shard=None, gather_episodes: bool = True):
        """One block of ``batch_size`` episodes; ``epsilon`` a float or a 0-d
        tensor on the device; ``index`` (>= 0) fixes every env's scenario.
        ``env_draws`` = {"reset": draws, "step": [draws per step]} feeds the
        env explicit randomness (tests); otherwise ``generator`` (default:
        the runner's) draws it. Returns (batch dict (B, T+1, ...), stats dict
        of device tensors). Nothing here waits for the device, so the fused
        pipeline's CUDA graph can capture it. ``record`` adds
        ``stats["render"]``, a list of T per-step dicts.

        ``shard`` (a ``parallel.mesh.MeshContext``): ``batch_size`` is the
        global block; this rank steps its ``batch_size / n`` envs, every draw
        made at the global shape and sliced, and the ranks' stats are then
        gathered, rank by rank, so every rank returns the block's stats one
        process stepping all of it would; so is the episode batch with
        ``gather_episodes`` (the classic loop's ring), else each rank keeps
        its own ``batch_size / n`` episodes (the fused loop's sharded ring)."""
        env, mac = self.env, self.mac
        gen = self.generator if generator is None else generator
        T = self.episode_limit
        B = batch_size if shard is None else batch_size // shard.n_data
        dev = mac.device
        reset_draws = None if env_draws is None else env_draws["reset"]
        if shard is not None:
            if reset_draws is None:
                reset_draws = env.draw_reset(batch_size, gen)
            reset_draws = shard.shard(reset_draws)
        state, obs = env.reset(B, generator=gen, test=test, index=index, draws=reset_draws)
        obs0 = obs
        hidden = mac.init_hidden(B)
        alive = torch.ones((B,), dtype=torch.bool, device=dev)
        last_oh = torch.zeros((B, self.n_agents, self.n_actions), device=dev)
        ep_ret = torch.zeros((B,), device=dev)
        ep_len = torch.zeros((B,), dtype=torch.long, device=dev)
        # final-info values captured at each env's termination step
        final_info = {k: torch.zeros((B,), device=dev)
                      for k in getattr(env, "final_info_keys", ("solved",))}
        outs = {"actions": [], "reward": [], "terminated": [], "filled": [], "obs": []}
        frames = []
        step_kw = {"record": True} if record else {}

        for t in range(T):
            q, hidden_new = mac.forward_step(obs, last_oh, hidden)
            if self.heuristic:
                # the env gates the choice against avail_actions (heuristic_rest)
                actions = env.heuristic_actions(state, obs["avail_actions"])
            else:
                actions = self.select(q, obs["avail_actions"], epsilon, test, gen, shard)
            step_draws = None if env_draws is None else env_draws["step"][t]
            if shard is not None and hasattr(env, "draw_step"):
                if step_draws is None:
                    step_draws = env.draw_step(batch_size, gen)
                step_draws = shard.shard(step_draws)
            n_state, n_obs, rew, done, info = env.step(state, actions, generator=gen,
                                                       draws=step_draws, **step_kw)
            env_term = done & ~info["episode_limit"]

            state = _select(alive, n_state, state)
            obs = _select(alive, n_obs, obs)
            hidden = _select(alive, hidden_new, hidden)
            actions = _mask_like(alive, actions)
            last_oh = _mask_like(alive, torch.nn.functional.one_hot(
                actions, self.n_actions).float())
            ep_ret = ep_ret + _mask_like(alive, rew)
            ep_len = ep_len + alive.long()
            just_done = alive & done
            final_info = {k: torch.where(just_done, info[k].float(), v)
                          for k, v in final_info.items()}

            outs["actions"].append(actions)
            outs["reward"].append(_mask_like(alive, rew))
            outs["terminated"].append(env_term & alive)
            outs["filled"].append(alive)
            outs["obs"].append({k: _mask_like(alive, v) for k, v in obs.items()})
            if record:
                frames.append({**env.render_state(state), **info["render"]})
            alive = alive & ~done

        def seq(xs):  # T x (B, ...) -> (B, T+1, ...) with a zero last slot
            x = torch.stack(xs, dim=1)
            return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)

        batch = {k: torch.stack([obs0[k]] + [o[k] for o in outs["obs"]], dim=1) for k in obs0}
        actions = seq(outs["actions"])
        filled = torch.stack(outs["filled"], dim=1)[..., None]
        filled = torch.cat([torch.ones_like(filled[:, :1]), filled], dim=1)
        # actions at t were written iff the env was alive at the start of t
        written = torch.cat([filled[:, 1:, 0], torch.zeros_like(filled[:, :1, 0])], dim=1)
        batch.update(
            actions=actions,
            actions_onehot=torch.nn.functional.one_hot(actions, self.n_actions).float()
            * written[:, :, None, None],
            reward=seq(outs["reward"])[..., None],
            terminated=seq(outs["terminated"])[..., None],
            filled=filled,
        )
        stats = {"ep_returns": ep_ret, "ep_lengths": ep_len, "final_info": final_info}
        if shard is not None and gather_episodes:
            batch, stats = shard.gather_batch((batch, stats))
        elif shard is not None:
            stats = shard.gather_batch(stats)
        if record:
            stats["render"] = frames
        return batch, stats

    def select(self, q, avail, epsilon, test: bool, generator, shard=None):
        """The actions of one step, by ``agent_output_type`` and
        ``action_selector`` (``refil_tpu/runners/vector_runner.py:115-135``):
        pi_logits -> ``pi_logits_transform`` then ``multinomial``; else the
        configured selector over the Q-values. ``shard``: the selectors'."""
        test_greedy = bool(getattr(self.args, "test_greedy", True))
        if self.output_type == "pi_logits":
            probs = pi_logits_transform(q, avail, epsilon, test, mask_before_softmax=bool(
                getattr(self.args, "mask_before_softmax", True)))
            return multinomial(probs, avail, test_greedy, test, generator=generator,
                               shard=shard)
        if self.selector == "multinomial":
            return multinomial(q, avail, test_greedy, test, generator=generator, shard=shard)
        return epsilon_greedy(q, avail, epsilon, generator=generator, shard=shard)

    def batch_spec(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape of one episode, dtype) of each plane ``rollout`` returns,
        from a one-env reset on a throwaway generator (no agent forward, no
        draw from the runner's generator)."""
        T1, Na, A = self.episode_limit + 1, self.n_agents, self.n_actions
        _, obs = self.env.reset(1, generator=torch.Generator(device=self.mac.device))
        spec = {k: ((T1,) + tuple(v.shape[1:]), v.dtype) for k, v in obs.items()}
        spec.update(actions=((T1, Na), torch.int64), actions_onehot=((T1, Na, A), torch.float32),
                    reward=((T1, 1), torch.float32), terminated=((T1, 1), torch.bool),
                    filled=((T1, 1), torch.bool))
        return spec

    def run(self, test_mode: bool = False, batch_size: Optional[int] = None,
            test_scen: Optional[bool] = None, index: Optional[int] = None,
            generator: Optional[torch.Generator] = None,
            record: bool = False) -> Dict[str, torch.Tensor]:
        """One episode block with the scheduled epsilon (0 in test mode);
        accounts its stats and returns the episode batch. ``batch_size``
        overrides ``batch_size_run`` for this call: the fused loop runs all
        of ``test_nepisode`` as one wider rollout. ``test_scen`` (default:
        ``test_mode``) is the env's test flag, ``index`` a fixed scenario
        (eval-only runs); ``generator`` draws in place of the runner's (the
        loops' test runs, so they leave the training stream alone).
        ``record`` keeps the block's per-step render states and extras in
        ``last_recording``, a list of T dicts of numpy arrays (B, ...). A
        training block under a data mesh (``self.mesh``) is sharded over the
        ranks and gathered; a test block runs whole, alike on every rank."""
        if test_scen is None:
            test_scen = test_mode
        self.epsilon = self.schedule.eval_host(self.t_env)
        eps = 0.0 if test_mode else self.epsilon
        extra = {}
        if record:
            extra["record"] = True
        if self.mesh is not None and not test_mode:
            extra["shard"] = self.mesh
        batch, stats = self.rollout(eps, self.batch_size if batch_size is None else batch_size,
                                    test=bool(test_scen), index=index, generator=generator,
                                    **extra)
        if record:
            self.last_recording = [_to_host(frame) for frame in stats.pop("render")]
        stats = _to_host(stats)
        if not test_mode:
            self.t_env += int(stats["ep_lengths"].sum())
        self.account_block(stats, test_mode=test_mode)
        return batch

    def account_block(self, stats, test_mode: bool = False) -> None:
        """Fold one block's stats, fetched to the host (numpy arrays), into
        the accumulators and log on the reference's cadence."""
        block_bs = int(stats["ep_returns"].shape[0])
        cur_stats = self.test_stats if test_mode else self.train_stats
        cur_returns = self.test_returns if test_mode else self.train_returns
        final_info = stats["final_info"]
        for k, v in final_info.items():
            cur_stats[k] = float(v.sum()) + cur_stats.get(k, 0.0)
        if "battle_won" in final_info:
            self.battles_won += int(final_info["battle_won"].sum())
            self.battles_game += block_bs
            if "episode_limit" in final_info:
                self.timeouts += int(final_info["episode_limit"].sum())
        cur_stats["n_episodes"] = block_bs + cur_stats.get("n_episodes", 0)
        cur_stats["ep_length"] = float(stats["ep_lengths"].sum()) + cur_stats.get("ep_length", 0.0)
        cur_returns.extend(stats["ep_returns"].tolist())

        if self.logger is None:
            return
        n_test_runs = max(1, self.args.test_nepisode // self.batch_size) * self.batch_size
        if test_mode and len(self.test_returns) == n_test_runs:
            self._log(cur_returns, cur_stats, "test_")
        elif not test_mode and self.t_env - self.log_train_stats_t >= self.args.runner_log_interval:
            self._log(cur_returns, cur_stats, "")
            self.logger.log_stat("epsilon", self.epsilon, self.t_env)
            if self.battles_game:
                for k, v in self.env_stats().items():
                    self.logger.log_stat(k, v, self.t_env)
            self.log_train_stats_t = self.t_env

    def env_stats(self) -> Dict[str, float]:
        """Cumulative battle stats under the reference env's names;
        ``restarts`` is always 0 (an env here cannot crash mid-episode)."""
        return {
            "battles_won": float(self.battles_won),
            "battles_game": float(self.battles_game),
            "battles_draw": float(self.timeouts),
            "win_rate": self.battles_won / max(self.battles_game, 1),
            "timeouts": float(self.timeouts),
            "restarts": 0.0,
        }

    def _log(self, returns, stats, prefix):
        self.logger.log_stat(prefix + "return_mean", float(np.mean(returns)), self.t_env)
        self.logger.log_stat(prefix + "return_std", float(np.std(returns)), self.t_env)
        returns.clear()
        for k, v in stats.items():
            if k != "n_episodes":
                self.logger.log_stat(prefix + k + "_mean", v / stats["n_episodes"], self.t_env)
        stats.clear()

