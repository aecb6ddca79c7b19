"""Minari/D4RL-compatible dataset layer (≙ border_tpu/data/minari.py).

≙ border-minari's dataset handling end to end:

- :class:`MinariDataset` — load + introspect + create replay buffer +
  **recover_environment** (border-minari/src/dataset.rs:13-217: load_dataset
  :18-31, get_num_transitions :40-55, create_replay_buffer :64-100,
  recover_environment :101-217).  Resolves an id to the local
  committed-corpus registry (``artifacts/datasets/<id>.npz`` + ``.json``
  metadata) first, then the Minari python package when it imports, then
  Minari-format HDF5 files in the standard search roots (read with
  ``h5py``, imported only there).
- per-domain **converters** for dict observations — the counterpart of the
  reference's ~1,600-LoC d4rl converter tree
  (border-minari/src/d4rl/{antmaze,kitchen,pointmaze,pen}/**): goal-reaching
  domains expose ``{observation, desired_goal, achieved_goal}`` dicts that
  must be flattened consistently for both dataset ingestion and the
  recovered env (MinariConverter trait, border-minari/src/converter.rs:6-46).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from border_tpu_torch.data.datasets import (
    NormalizedEvaluator,
    OfflineDataset,
    normalized_score,
)
from border_tpu_torch.replay.buffer import ReplayBuffer, ReplayBufferState

LOCAL_DATASET_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "artifacts", "datasets"
)


# ---------------------------------------------------------------------------
# converters (≙ MinariConverter, border-minari/src/converter.rs:6-46;
# d4rl per-domain impls border-minari/src/d4rl/**)
# ---------------------------------------------------------------------------
class MinariConverter:
    """obs/act conversion between raw episode arrays and framework arrays."""

    def convert_observation(self, obs: Any) -> np.ndarray:
        return np.asarray(obs)

    def convert_action(self, act: Any) -> np.ndarray:
        return np.asarray(act)


class GoalDictConverter(MinariConverter):
    """Goal-reaching dict obs → flat vector, in a fixed key order
    (≙ pointmaze/antmaze converters, border-minari/src/d4rl/pointmaze/**).

    Dict episodes arrive as {key: [T+1, ...]} arrays; flattening
    concatenates the configured keys along the feature axis.
    """

    def __init__(self, keys=("observation", "desired_goal")):
        self.keys = tuple(keys)

    def convert_observation(self, obs: Any) -> np.ndarray:
        if isinstance(obs, dict):
            parts = [np.asarray(obs[k], np.float32) for k in self.keys]
            parts = [p[..., None] if p.ndim == 1 else p for p in parts]
            return np.concatenate(parts, axis=-1)
        return np.asarray(obs)


CONVERTERS: Dict[str, Callable[[], MinariConverter]] = {
    # domain prefix → converter (≙ the d4rl converter registry)
    "pointmaze": lambda: GoalDictConverter(),
    "antmaze": lambda: GoalDictConverter(),
    "fetch": lambda: GoalDictConverter(),
    "kitchen": lambda: GoalDictConverter(keys=("observation",)),
}


def converter_for(dataset_id: str) -> MinariConverter:
    for prefix, factory in CONVERTERS.items():
        if dataset_id.lower().startswith(prefix):
            return factory()
    return MinariConverter()


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MinariDataset:
    """A loaded offline dataset + its environment metadata."""

    dataset_id: str
    data: OfflineDataset
    env_name: Optional[str] = None
    ref_min: Optional[float] = None
    ref_max: Optional[float] = None
    behavior_return: Optional[float] = None

    # -- loading (≙ MinariDataset::load_dataset, dataset.rs:18-31) ---------
    @classmethod
    def load(cls, dataset_id: str,
             converter: Optional[MinariConverter] = None) -> "MinariDataset":
        """Resolve ``dataset_id``: the local committed-corpus registry
        first (always reachable, even with the minari package installed —
        a committed corpus therefore *shadows* any same-id dataset the
        minari package could serve), then the Minari package when
        importable.  Dict-obs local corpora are stored RAW and converted
        at load (``converter`` or the domain registry); flat local corpora
        are already post-conversion, so a ``converter`` argument is
        ignored there (with a warning)."""
        npz = os.path.join(LOCAL_DATASET_DIR, f"{dataset_id}.npz")
        if os.path.exists(npz):
            return cls._from_local(dataset_id, converter)
        try:
            import minari  # type: ignore
        except ImportError:
            minari = None
        pkg_err = None
        if minari is not None:
            try:
                return cls._from_minari_pkg(dataset_id, minari, converter)
            except Exception as e:
                # unknown to the package (or its download failed): the
                # on-disk Minari-format search below stays reachable, but
                # not silently: warn now, chain into a final failure
                pkg_err = e
                import warnings

                warnings.warn(
                    f"minari package failed to serve {dataset_id!r} "
                    f"({type(e).__name__}: {e}); falling back to on-disk "
                    f"Minari-format / committed local corpora",
                    stacklevel=2,
                )
        # any failure of the on-disk fallbacks chains the package's error
        # (None without the package), whichever of them raised
        try:
            h5 = _find_minari_hdf5(dataset_id)
            if h5 is not None:
                return cls._from_minari_hdf5(dataset_id, h5, converter)
            return cls._from_local(dataset_id)  # raises with local listing
        except Exception as e:
            if pkg_err is None:
                raise
            raise e from pkg_err

    @classmethod
    def _from_minari_pkg(cls, dataset_id: str, minari,
                         converter: Optional[MinariConverter]) -> "MinariDataset":
        conv = converter or converter_for(dataset_id)
        ds = minari.load_dataset(dataset_id)
        episodes = []
        for ep in ds.iterate_episodes():
            episodes.append({
                "obs": conv.convert_observation(ep.observations),
                "act": conv.convert_action(np.asarray(ep.actions)),
                "reward": np.asarray(ep.rewards),
                "terminated": bool(np.asarray(ep.terminations)[-1]),
            })
        env_name = None
        spec = getattr(ds, "spec", None)
        if spec is not None:
            env_spec = getattr(spec, "env_spec", None)
            env_name = getattr(env_spec, "id", None)
        ref_min = getattr(ds, "ref_min_score", None)
        ref_max = getattr(ds, "ref_max_score", None)
        return cls(
            dataset_id=dataset_id,
            data=OfflineDataset.from_episodes(episodes),
            env_name=env_name,
            ref_min=ref_min,
            ref_max=ref_max,
        )

    @classmethod
    def _from_minari_hdf5(cls, dataset_id: str, path: str,
                          converter: Optional[MinariConverter]
                          ) -> "MinariDataset":
        """Load a Minari-format ``main_data.hdf5`` WITHOUT the minari
        package — the storage schema the package writes under
        ``~/.minari/datasets/<id>/data/`` (episode groups with
        observations/actions/rewards/terminations/truncations; dict obs
        as sub-groups).  Lets a user point the framework at an on-disk
        Minari dataset with only h5py installed (≙ the dataset parsing
        border-minari does through pyo3, dataset.rs:64-100)."""
        conv = converter or converter_for(dataset_id)
        episodes, meta = load_minari_hdf5(path)
        eps = [{
            "obs": conv.convert_observation(ep["observations"]),
            "act": conv.convert_action(ep["actions"]),
            "reward": ep["rewards"],
            "terminated": bool(ep["terminations"][-1]),
        } for ep in episodes]
        return cls(
            dataset_id=dataset_id,
            data=OfflineDataset.from_episodes(eps),
            env_name=meta.get("env_name"),
            ref_min=meta.get("ref_min"),
            ref_max=meta.get("ref_max"),
            behavior_return=meta.get("behavior_return"),
        )

    @classmethod
    def _from_local(cls, dataset_id: str,
                    converter: Optional[MinariConverter] = None
                    ) -> "MinariDataset":
        npz = os.path.join(LOCAL_DATASET_DIR, f"{dataset_id}.npz")
        meta_path = os.path.join(LOCAL_DATASET_DIR, f"{dataset_id}.json")
        if not os.path.exists(npz):
            available = sorted(
                f[:-4] for f in os.listdir(LOCAL_DATASET_DIR)
                if f.endswith(".npz")
            ) if os.path.isdir(LOCAL_DATASET_DIR) else []
            raise KeyError(
                f"dataset {dataset_id!r} not found locally and the minari "
                f"package is unavailable; local corpora: {available}"
            )
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        data = OfflineDataset.from_npz(npz)
        if isinstance(data.obs, dict):
            # raw goal-dict corpus: convert at load, exactly like the
            # package path (≙ the per-domain d4rl converters,
            # border-minari/src/d4rl/**)
            conv = converter or converter_for(dataset_id)
            data = dataclasses.replace(
                data,
                obs=conv.convert_observation(data.obs),
                next_obs=conv.convert_observation(data.next_obs),
                act=conv.convert_action(data.act),
            )
        elif converter is not None:
            import warnings

            warnings.warn(
                f"{dataset_id!r} resolves to a local flat corpus, which is "
                "stored post-conversion — the converter argument is "
                "ignored", stacklevel=2,
            )
        return cls(
            dataset_id=dataset_id,
            data=data,
            env_name=meta.get("env"),
            ref_min=meta.get("ref_min"),
            ref_max=meta.get("ref_max"),
            behavior_return=meta.get("behavior_return"),
        )

    # -- introspection (≙ get_num_transitions, dataset.rs:40-55) -----------
    def get_num_transitions(self) -> int:
        return len(self.data)

    # -- buffer creation (≙ create_replay_buffer, dataset.rs:64-100) -------
    def create_replay_buffer(
        self, buffer: Optional[ReplayBuffer] = None,
        limit: Optional[int] = None,
    ) -> ReplayBufferState:
        """The dataset in ``buffer`` (default: a flat buffer of its size on
        the GPU)."""
        if buffer is None:
            buffer = ReplayBuffer(capacity=len(self.data))
        return self.data.to_replay_buffer(buffer, limit=limit)

    # -- env recovery (≙ recover_environment, dataset.rs:101-217) ----------
    def recover_environment(self, **kwargs):
        """Build the environment this dataset was collected on, via the
        framework env registry."""
        if self.env_name is None:
            raise ValueError(
                f"dataset {self.dataset_id!r} records no environment id"
            )
        from border_tpu_torch.envs import make

        return make(self.env_name, **kwargs)

    # -- evaluation (≙ MinariEvaluator, border-minari/src/evaluator.rs) ----
    def make_evaluator(self, n_episodes: int = 10, max_steps: int = 1_000,
                       **kwargs) -> NormalizedEvaluator:
        if self.ref_min is None or self.ref_max is None:
            raise ValueError(
                f"dataset {self.dataset_id!r} has no ref_min/ref_max scores"
            )
        return NormalizedEvaluator(
            self.recover_environment(), n_episodes=n_episodes,
            max_steps=max_steps, ref_min=self.ref_min, ref_max=self.ref_max,
            **kwargs,
        )

    def behavior_normalized_score(self) -> float:
        if self.behavior_return is None:
            raise ValueError("no behavior_return recorded for this dataset")
        return normalized_score(self.behavior_return, self.ref_min, self.ref_max)


MINARI_FORMAT_DIR = os.path.join(LOCAL_DATASET_DIR, "minari_format")


def _find_minari_hdf5(dataset_id: str) -> Optional[str]:
    """Locate ``<id>/data/main_data.hdf5`` in the standard Minari search
    roots: $MINARI_DATASETS_PATH, ~/.minari/datasets, and the committed
    fixture dir."""
    roots = [
        os.environ.get("MINARI_DATASETS_PATH"),
        os.path.expanduser("~/.minari/datasets"),
        MINARI_FORMAT_DIR,
    ]
    for root in roots:
        if not root:
            continue
        p = os.path.join(root, dataset_id, "data", "main_data.hdf5")
        if os.path.exists(p):
            return p
    return None


def load_minari_hdf5(path: str):
    """Parse a Minari-format HDF5 file → (episodes, meta).

    Episodes are dicts with T+1-row ``observations`` (dict obs become
    {key: [T+1, ...]} dicts), T-row actions/rewards/terminations/
    truncations — the exact shape ``minari.load_dataset`` episodes expose
    (and which border-minari consumes at dataset.rs:64-100).  ``meta``
    carries env_name plus the evaluation attrs the package path exposes
    (ref_min/ref_max D4RL reference scores, behavior_return)."""
    import h5py

    episodes = []
    with h5py.File(path, "r") as f:
        names = sorted(
            (n for n in f.keys() if n.startswith("episode_")),
            key=lambda n: int(n.split("_")[1]),
        )
        for name in names:
            g = f[name]
            obs_node = g["observations"]
            if isinstance(obs_node, h5py.Group):
                obs = {k: np.asarray(obs_node[k]) for k in obs_node.keys()}
            else:
                obs = np.asarray(obs_node)
            episodes.append({
                "observations": obs,
                "actions": np.asarray(g["actions"]),
                "rewards": np.asarray(g["rewards"]),
                "terminations": np.asarray(g["terminations"]),
                "truncations": np.asarray(g["truncations"]),
            })
        meta = {}
        spec = f.attrs.get("env_spec")
        if spec is not None:
            try:
                meta["env_name"] = json.loads(spec).get("id")
            except (TypeError, ValueError):
                pass
        for attr, key in (("ref_min_score", "ref_min"),
                          ("ref_max_score", "ref_max"),
                          ("behavior_return", "behavior_return")):
            if attr in f.attrs:
                meta[key] = float(f.attrs[attr])
    return episodes, meta


def list_local_datasets() -> List[str]:
    if not os.path.isdir(LOCAL_DATASET_DIR):
        return []
    return sorted(
        f[:-4] for f in os.listdir(LOCAL_DATASET_DIR) if f.endswith(".npz")
    )
