"""Configuration over the reference's env-var contract — the fields this
slice of the port reads, with the same names, defaults and parsing as
``kmlserver_tpu/config.py`` (``MiningConfig``, ``ServingConfig``).

``KMLS_TORCH_DEVICE`` is the port's own knob: the device the two
``python -m`` entry points run on (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels).
"""

from __future__ import annotations

import dataclasses
import os

from .utils.envfile import load_dotenv

# Columns dropped from the raw CSV before any processing
# (reference: machine-learning/main.py:42).
DROP_COLUMNS = ("duration_ms",)

# First dataset index in the rotation scheme (reference: machine-learning/main.py:46).
BASE_INDEX = 1


def _getenv_int(name: str, default: int) -> int:
    raw = os.getenv(name)
    return int(raw) if raw not in (None, "") else default


def _getenv_float(name: str, default: float) -> float:
    raw = os.getenv(name)
    return float(raw) if raw not in (None, "") else default


def _getenv_bool(name: str, default: bool) -> bool:
    raw = os.getenv(name)
    if raw in (None, ""):
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def torch_device_from_env() -> str:
    """``KMLS_TORCH_DEVICE`` (default ``cuda``)."""
    return os.getenv("KMLS_TORCH_DEVICE") or "cuda"


@dataclasses.dataclass(frozen=True)
class MiningConfig:
    """Batch mining job config (reference: machine-learning/main.py:17-49,
    kubernetes/job.yaml:24-40)."""

    base_dir: str = "./api-data"
    datasets_dir: str = ""
    regex_filename: str = "2023_spotify_ds*.csv"
    min_support: float = 0.05
    pickles_folder: str = "pickles"
    recommendations_file: str = "recommendations.pickle"
    best_tracks_file: str = "best_tracks.pickle"
    data_invalidation_file: str = "last_execution.txt"
    top_tracks_save_percentile: float = 0.03
    artists_mapping_file: str = "artistsMapping.pickle"
    repeated_tracks_file: str = "trackNameToRepeatedUris.pickle"
    track_info_file: str = "trackIdsToInfo.pickle"
    datasets_list_file: str = "datasets_list.txt"
    dataset_history_file: str = "dataset_history.csv"
    sample_ratio: float = 1.0
    # padded per-antecedent rule-row capacity (consequents kept per song)
    k_max_consequents: int = 256
    # "support" = the reference fast path's semantics; "confidence" = the
    # dormant slow path's asymmetric pairwise confidence
    confidence_mode: str = "support"
    min_confidence: float = 0.04
    # above this vocabulary size, prune infrequent items (exact, by the
    # Apriori property) before pair counting
    prune_vocab_threshold: int = 512
    write_tensor_artifact: bool = True
    write_manifest: bool = True

    @property
    def pickles_dir(self) -> str:
        return os.path.join(self.base_dir, self.pickles_folder)

    @staticmethod
    def from_env(dotenv_path: str | None = ".env") -> "MiningConfig":
        if dotenv_path:
            load_dotenv(dotenv_path)
        base_dir = os.getenv("BASE_DIR", "./api-data")
        return MiningConfig(
            base_dir=base_dir,
            datasets_dir=os.getenv("DATASETS_DIR", os.path.join(base_dir, "datasets")),
            regex_filename=os.getenv("REGEX_FILENAME", "2023_spotify_ds*.csv"),
            min_support=_getenv_float("MIN_SUPPORT", 0.05),
            pickles_folder=os.getenv("PICKLES_FOLDER", "pickles"),
            recommendations_file=os.getenv("RECOMMENDATIONS_FILE", "recommendations.pickle"),
            best_tracks_file=os.getenv("BEST_TRACKS_FILE", "best_tracks.pickle"),
            data_invalidation_file=os.getenv("DATA_INVALIDATION_FILE", "last_execution.txt"),
            top_tracks_save_percentile=_getenv_float("TOP_TRACKS_SAVE_PERCENTILE", 0.03),
            artists_mapping_file=os.getenv("ARTISTS_MAPPING_FILE", "artistsMapping.pickle"),
            repeated_tracks_file=os.getenv("REPEATED_TRACKS_FILE", "trackNameToRepeatedUris.pickle"),
            track_info_file=os.getenv("TRACK_INFO_FILE", "trackIdsToInfo.pickle"),
            datasets_list_file=os.getenv("DATASETS_LIST_FILE", "datasets_list.txt"),
            dataset_history_file=os.getenv("DATASET_HISTORY_FILE", "dataset_history.csv"),
            sample_ratio=_getenv_float("SAMPLE_RATIO", 1.0),
            k_max_consequents=_getenv_int("KMLS_K_MAX_CONSEQUENTS", 256),
            confidence_mode=os.getenv("KMLS_CONFIDENCE_MODE", "support"),
            min_confidence=_getenv_float("KMLS_MIN_CONFIDENCE", 0.04),
            prune_vocab_threshold=_getenv_int("KMLS_PRUNE_VOCAB_THRESHOLD", 512),
            write_tensor_artifact=_getenv_bool("KMLS_WRITE_TENSOR_ARTIFACT", True),
            write_manifest=_getenv_bool("KMLS_WRITE_MANIFEST", True),
        )


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Online API config (reference: rest_api/app/main.py:31-50,
    kubernetes/deployment.yaml:33-53)."""

    version: str = "V1.1"
    base_dir: str = "./api-data/"
    pickle_dir: str = "pickles/"
    recommendations_file: str = "recommendations.pickle"
    best_tracks_file: str = "best_tracks.pickle"
    data_invalidation_file: str = "last_execution.txt"
    k_best_tracks: int = 10
    polling_wait_in_minutes: float = 5.0
    port: int = 80
    # max seed songs per request that reach the lookup (the rest are cut)
    max_seed_tracks: int = 128
    # load rule tensors from the .npz twin when present (else the pickle)
    prefer_tensor_artifact: bool = True

    @property
    def pickles_dir(self) -> str:
        return os.path.join(self.base_dir, self.pickle_dir)

    @staticmethod
    def from_env(dotenv_path: str | None = ".env") -> "ServingConfig":
        if dotenv_path:
            load_dotenv(dotenv_path)
        return ServingConfig(
            version=os.getenv("VERSION", "V1.1"),
            base_dir=os.getenv("BASE_DIR", "./api-data/"),
            pickle_dir=os.getenv("PICKLE_DIR", "pickles/"),
            recommendations_file=os.getenv("RECOMMENDATIONS_FILE", "recommendations.pickle"),
            best_tracks_file=os.getenv("BEST_TRACKS_FILE", "best_tracks.pickle"),
            data_invalidation_file=os.getenv("DATA_INVALIDATION_FILE", "last_execution.txt"),
            k_best_tracks=_getenv_int("K_BEST_TRACKS", 10),
            polling_wait_in_minutes=_getenv_float("POLLING_WAIT_IN_MINUTES", 5.0),
            port=_getenv_int("KMLS_PORT", 80),
            max_seed_tracks=_getenv_int("KMLS_MAX_SEED_TRACKS", 128),
            prefer_tensor_artifact=_getenv_bool("KMLS_PREFER_TENSOR_ARTIFACT", True),
        )
