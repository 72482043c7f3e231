"""Q-learner: 1-step double-Q TD with (imagined) value-decomposition mixing.
Port of ``refil_tpu/learners/q_learner.py``.

One update: whole-episode forward -> chosen Qs -> the REFIL ×3 split ->
double-Q target from the live net's argmax -> live and target mixing ->
1-step target r + γ(1−term)·Q_tot_target (or TD(λ) returns under
``td_lambda``) -> masked MSE + λ-weighted imagined loss -> global-norm clip
-> RMSprop. The target networks are deep copies, hard-synced every
``target_update_interval`` episodes.

Optimiser: ``torch.optim.RMSprop(lr, alpha=optim_alpha, eps=optim_eps,
weight_decay=weight_decay)``, the rule the JAX package's optax chain
(clip -> ``add_decayed_weights`` -> rmsprop) mimics: RMSprop adds wd·p to
the gradient after the manual clip, as the chain does; on CUDA it is
``capturable`` (its step count on the card), so the fused pipeline's CUDA
graph can capture it; the CPU keeps the default. The clip is optax's
``clip_by_global_norm``: gradients are left alone when the global norm is
below ``grad_norm_clip`` and become ``g / norm * grad_norm_clip`` otherwise
(``torch.nn.utils.clip_grad_norm_`` would scale by ``clip / (norm + 1e-6)``).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..controllers.mac import compute_dtype
from ..modules.mixers import MIXER_REGISTRY, FlexQMixer, LinearFlexQMixer, QMixer, VDNMixer
from ..ops.masks import draw_imagine_groups
from ..utils.rl_utils import build_td_lambda_targets

NEG = -9999999.0  # Q of an unavailable action in the double-Q argmax


def _gather(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return q.gather(3, a[..., None]).squeeze(3)


class QLearner:
    def __init__(self, mac, args, env_info, device, generator=None, init_generator=None):
        """``generator`` draws the imagine bipartitions; ``init_generator``
        draws the mixer's initial weights."""
        self.mac = mac
        self.args = args
        self.device = torch.device(device)
        self.generator = generator
        self.n_agents = env_info["n_agents"]
        self.is_imagine = "imagine" in args.agent

        self.mixer = None
        mixer_name = getattr(args, "mixer", None)
        if mixer_name == "vdn":
            self.mixer = VDNMixer()
        elif mixer_name in ("flex_qmix", "lin_flex_qmix"):
            if "entity_shape" not in env_info:
                raise ValueError(f"mixer {mixer_name!r} mixes over entities; the flat scheme's "
                                 "mixers are qmix and vdn")
            cls = FlexQMixer if mixer_name == "flex_qmix" else LinearFlexQMixer
            # the mixer's entities include the last-action block, as the
            # agent's inputs do
            self.mixer = cls(
                n_agents=self.n_agents,
                input_dim=mac.input_shape,
                mixing_embed_dim=args.mixing_embed_dim,
                hypernet_embed=args.hypernet_embed,
                attn_n_heads=args.attn_n_heads,
                softmax_mixing_weights=bool(args.softmax_mixing_weights),
                pooling_type=getattr(args, "pooling_type", None),
                dtype=compute_dtype(args),
                use_kernel=bool(getattr(args, "use_pallas_attention", True)),
                generator=init_generator,
            ).to(self.device)
        elif mixer_name == "qmix":
            if "state_shape" not in env_info:
                raise ValueError("mixer 'qmix' mixes over the flat scheme's state; this env "
                                 "has none (its mixers: flex_qmix, lin_flex_qmix, vdn)")
            self.mixer = QMixer(
                n_agents=self.n_agents,
                state_dim=int(env_info["state_shape"]),
                mixing_embed_dim=args.mixing_embed_dim,
                hypernet_layers=getattr(args, "hypernet_layers", 1),
                hypernet_embed=getattr(args, "hypernet_embed", 64),
                softmax_mixing_weights=bool(args.softmax_mixing_weights),
                state_masks=getattr(args, "state_masks", None),
                generator=init_generator,
            ).to(self.device)
        elif mixer_name is not None:
            raise ValueError(f"mixer {mixer_name!r} not recognised; ported: "
                             f"{sorted(MIXER_REGISTRY)}")

        self.params = list(mac.parameters())
        if self.mixer is not None:
            self.params += list(self.mixer.parameters())
        self.optimiser = torch.optim.RMSprop(self.params, lr=args.lr, alpha=args.optim_alpha,
                                             eps=args.optim_eps,
                                             weight_decay=float(getattr(args, "weight_decay", 0)),
                                             capturable=self.device.type == "cuda")
        self.target_mac = copy.deepcopy(mac)
        self.target_mixer = copy.deepcopy(self.mixer)
        self.target_params = list(self.target_mac.parameters())
        if self.target_mixer is not None:
            self.target_params += list(self.target_mixer.parameters())
        self.last_target_update_episode = 0
        self.log_stats_t = -getattr(args, "learner_log_interval", 2000) - 1

    def param_names(self) -> List[str]:
        """A name for each of ``params`` (and of ``target_params``), in order."""
        names = [f"agent.{n}" for n, _ in self.mac.agent.named_parameters()]
        if self.mixer is not None:
            names += [f"mixer.{n}" for n, _ in self.mixer.named_parameters()]
        return names

    # ------------------------------------------------------------------
    @staticmethod
    def td_mask(filled: torch.Tensor, terminated: torch.Tensor) -> torch.Tensor:
        """(B, T, 1) float: the steps the TD loss counts, filled and not
        after the episode's termination; ``terminated`` is the batch's
        ``terminated[:, :-1]`` as float."""
        mask = filled.float()[:, :-1].clone()
        mask[:, 1:] = mask[:, 1:] * (1.0 - terminated[:, :-1])
        return mask

    def _loss(self, batch: Dict[str, torch.Tensor], imagine_draws=None,
              mask_elems: Optional[torch.Tensor] = None,
              stamp: Optional[Callable[[str], None]] = None):
        """The loss and metrics of one update. ``mask_elems`` (a 0-d tensor)
        is the global batch's mask count where ``batch`` is one rank's slice
        of it: the loss and every metric are then this slice's sums over the
        global denominators, which the ranks' all_reduce adds up.
        ``stamp("agents")`` runs once the live and target agents' forwards
        and the double-Q argmax are done, before the mixers."""
        args, mac = self.args, self.mac
        rewards = batch["reward"][:, :-1]
        actions = batch["actions"][:, :-1]
        terminated = batch["terminated"][:, :-1].float()
        mask = self.td_mask(batch["filled"], terminated)
        avail = batch["avail_actions"]

        metrics = {}
        if self.is_imagine:
            all_q, groups = mac.forward_episode(
                batch, imagine=True, generator=self.generator, imagine_draws=imagine_draws,
                use_gt_factors=bool(getattr(args, "train_gt_factors", False)),
                use_rand_gt_factors=bool(getattr(args, "train_rand_gt_factors", False)))
            all_chosen = _gather(all_q[:, :-1], torch.cat([actions] * 3, dim=0))
            mac_out = all_q.chunk(3, dim=0)[0]
            chosen, caqW, caqI = all_chosen.chunk(3, dim=0)
            caq_imagine = torch.cat([caqW, caqI], dim=2)
        else:
            mac_out = mac.forward_episode(batch)
            chosen = _gather(mac_out[:, :-1], actions)
            groups = None

        with torch.no_grad():
            target_q = self.target_mac.forward_episode(batch).masked_fill(~avail, NEG)
            if args.double_q:
                live = mac_out.detach().masked_fill(~avail, NEG)
                target_max_qvals = _gather(target_q, live.argmax(dim=3))
            else:
                target_max_qvals = target_q.max(dim=3).values
        if stamp is not None:
            stamp("agents")

        if self.mixer is not None:
            if isinstance(self.mixer, QMixer):
                # the flat scheme: the mixer reads the global state vector
                mix_in = (batch["state"],)
            elif isinstance(self.mixer, VDNMixer):
                mix_in = ()  # a sum, on either scheme
            else:
                # the entities include the last-action block, as the agent's do
                m_ents, _, m_em, _ = mac.build_episode_inputs(batch)
                mix_in = (m_ents, m_em)
            live_in = tuple(x[:, :-1] for x in mix_in)
            chosen_tot = self.mixer(chosen, *live_in)
            if self.is_imagine:
                g = tuple(gr[:, :-1] for gr in groups)
                caq_tot = self.mixer(caq_imagine, *live_in, imagine_groups=g)
            with torch.no_grad():
                target_tot = self.target_mixer(target_max_qvals, *mix_in)
        else:
            chosen_tot, target_tot = chosen, target_max_qvals
            caq_tot = caq_imagine if self.is_imagine else None

        td_lambda = getattr(args, "td_lambda", None)
        if td_lambda is not None:
            targets = build_td_lambda_targets(rewards, terminated, mask, target_tot, args.gamma,
                                              td_lambda).detach()
        else:
            targets = (rewards + args.gamma * (1.0 - terminated) * target_tot[:, 1:]).detach()
        td_error = chosen_tot - targets
        masked_td = td_error * mask
        if mask_elems is None:
            mask_elems = mask.sum()
        loss = (masked_td ** 2).sum() / mask_elems
        metrics["loss_td"] = loss
        if self.is_imagine:
            im_loss = (((caq_tot - targets) * mask) ** 2).sum() / mask_elems
            loss = (1 - args.lmbda) * loss + args.lmbda * im_loss
            metrics["im_loss"] = im_loss
        metrics["loss"] = loss
        metrics["td_error_abs"] = masked_td.abs().sum() / mask_elems
        metrics["q_taken_mean"] = (chosen_tot * mask).sum() / (mask_elems * self.n_agents)
        metrics["target_mean"] = (targets * mask).sum() / (mask_elems * self.n_agents)
        return loss, metrics

    def train_step(self, batch, imagine_draws=None, mask_elems=None, reduce=None,
                   stamp: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One update; returns its metrics as 0-d tensors (no host sync).
        ``reduce`` (``MeshContext.all_reduce_``) sums, in place over the
        ranks, one flat float32 bucket of every gradient and the metrics,
        after the backward and before the clip, so ``grad_norm``, the clip
        and RMSprop see the global gradient. ``stamp`` marks the update's
        stage boundaries: ``agents`` (in ``_loss``), then ``mix`` once the
        mixers, the targets and the loss are done, before the backward."""
        loss, metrics = self._loss(batch, imagine_draws, mask_elems, stamp)
        if stamp is not None:
            stamp("mix")
        self.optimiser.zero_grad(set_to_none=False)
        loss.backward()
        grads = [p.grad for p in self.params]
        if reduce is not None:
            names = list(metrics)
            bucket = torch.cat([g.reshape(-1) for g in grads]
                               + [torch.stack([metrics[k].detach().float() for k in names])])
            reduce(bucket)
            off = 0
            for g in grads:
                g.copy_(bucket[off:off + g.numel()].view_as(g))
                off += g.numel()
            metrics = dict(zip(names, bucket[off:]))
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        metrics["grad_norm"] = norm  # pre-clip
        clip = float(self.args.grad_norm_clip)
        with torch.no_grad():
            keep = norm < clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * clip))
        self.optimiser.step()
        return {k: v.detach() for k, v in metrics.items()}

    def updates(self, batches, imagine_draws: Optional[Sequence] = None, mesh=None,
                stamp: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """The ``training_iters`` updates in sequence on ``batches`` stacked on
        a leading iteration axis, with no host sync (``_train_iters_impl`` of
        the JAX learner). Returns the last update's metrics.
        ``imagine_draws[i]`` = (group_probs, groupA) for update i (tests).
        ``stamp`` (the fused pipeline's) marks three boundaries of update i:
        ``agents.<i>``, ``mix.<i>`` (``train_step``) and ``update.<i>``, after
        RMSprop.

        With ``mesh`` (a ``parallel.mesh.MeshContext``), ``batches`` is this
        rank's shard of the global sample (``MeshContext.gather_sample``):
        each update trains on it with the global mask count (one all_reduce
        of the block's per-update counts), REFIL's imagined groups drawn at
        the global shape and sliced (``imagine_draws`` too are global), and
        the mesh's all_reduce in ``train_step``."""
        n_iters = next(iter(batches.values())).shape[0]
        mask_elems = None
        if mesh is not None:
            filled, term = batches["filled"], batches["terminated"]
            mask_elems = self.td_mask(filled.flatten(0, 1),
                                      term.flatten(0, 1)[:, :-1].float())
            mask_elems = mesh.all_reduce_(mask_elems.reshape(n_iters, -1).sum(dim=1))
        metrics = {}
        for i in range(n_iters):
            batch = {k: v[i] for k, v in batches.items()}
            draws = None if imagine_draws is None else imagine_draws[i]
            mark = None if stamp is None else (lambda name, i=i: stamp(f"{name}.{i}"))
            if mesh is None:
                metrics = self.train_step(batch, draws, stamp=mark)
            else:
                if draws is None and self.is_imagine and not getattr(
                        self.args, "train_gt_factors", False):
                    entity_mask = batch["entity_mask"]
                    draws = draw_imagine_groups(entity_mask.shape[0] * mesh.n_data,
                                                entity_mask.shape[-1], self.generator,
                                                entity_mask.device)
                metrics = self.train_step(batch, None if draws is None else mesh.shard(draws),
                                          mask_elems=mask_elems[i], reduce=mesh.all_reduce_,
                                          stamp=mark)
            if mark is not None:
                mark("update")
        return metrics

    def train_iters(self, batches, t_env: int, episode_num: int,
                    imagine_draws: Optional[Sequence] = None, mesh=None
                    ) -> Dict[str, torch.Tensor]:
        """The classic loop's training: ``updates`` on ``batches``
        (``ReplayBuffer.sample_many``), then the target sync on its host
        episode cadence. Returns the last update's metrics."""
        metrics = self.updates(batches, imagine_draws, mesh)
        self._maybe_update_targets(episode_num)
        return metrics

    def _maybe_update_targets(self, episode_num: int) -> None:
        if (episode_num - self.last_target_update_episode) / self.args.target_update_interval >= 1.0:
            self.update_targets()
            self.last_target_update_episode = episode_num

    def update_targets(self) -> None:
        """Hard copy of the live networks into the targets."""
        self.sync_targets_where(torch.tensor(True, device=self.device))

    @torch.no_grad()
    def sync_targets_where(self, do_sync: torch.Tensor) -> None:
        """The fused pipeline's target sync: each target parameter becomes
        the live one where the 0-d bool ``do_sync`` holds, in place on the
        device (no host sync; ``pipeline.py:273-288`` of the JAX package)."""
        for p, t in zip(self.params, self.target_params):
            t.copy_(torch.where(do_sync, p, t))

    # --- diagnostics: gt-factor in-group proportion ---
    @property
    def has_gt_diagnostics(self) -> bool:
        return isinstance(self.mixer, LinearFlexQMixer) and self.is_imagine

    @torch.no_grad()
    def gt_diagnostics(self, batch, imagine_draws=None, mesh=None):
        """(ingroup_prop, gt_ingroup_prop) for imagine agents with the linear
        mixer (Group Matching, ``test_gt_factors``); None otherwise. With
        ``mesh``, ``batch`` is this rank's shard of the global one: the
        groups are drawn at the global shape and sliced, and each rank's
        sums over the global row count are added up (one all_reduce), so
        the values are the global batch's."""
        if not self.has_gt_diagnostics:
            return None
        mac = self.mac
        rep_actions = torch.cat([batch["actions"][:, :-1]] * 3, dim=0)
        m_ents, _, m_em, _ = mac.build_episode_inputs(batch)
        rows = None
        if mesh is not None:
            em = batch["entity_mask"]
            if imagine_draws is None:
                imagine_draws = draw_imagine_groups(em.shape[0] * mesh.n_data, em.shape[-1],
                                                    self.generator, em.device)
            imagine_draws = mesh.shard(imagine_draws)
            rows = em.shape[0] * mesh.n_data * (em.shape[1] - 1)
        out = {}
        for tag, kw in (("ingroup_prop", {}), ("gt_ingroup_prop", {"use_gt_factors": True})):
            all_q, groups = mac.forward_episode(batch, imagine=True, generator=self.generator,
                                                imagine_draws=imagine_draws, **kw)
            _, caqW, caqI = _gather(all_q[:, :-1], rep_actions).chunk(3, dim=0)
            g = tuple(gr[:, :-1] for gr in groups)
            _, prop = self.mixer(torch.cat([caqW, caqI], dim=2), m_ents[:, :-1], m_em[:, :-1],
                                 imagine_groups=g, ret_ingroup_prop=True, ingroup_rows=rows)
            out[tag] = prop
        if mesh is not None:
            props = mesh.all_reduce_(torch.stack([out[k].float() for k in out]))
            out = dict(zip(out, props))
        return out
