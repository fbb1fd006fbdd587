"""Fill the port's component registry (``core/registry.py``): the bootstrap
that ``Experiment.from_yaml`` and the entry points import.

Every component of the JAX package's registry is ported and registered
under its JAX package name, so that the YAML files of ``experiments/`` read
unchanged. Importing this module twice registers nothing twice.
"""

from .core.charset import AttentionCharset, Charset
from .core.registry import COMPONENTS
from .data.datasets import (
    DetectionICDARDataset,
    MixtureDataset,
    RecognitionListDataset,
    SyntheticDetectionDataset,
    SyntheticRecognitionDataset,
)
from .data.hard_synth import HardSyntheticDetectionDataset, HardSyntheticRecognitionDataset
from .data.lmdb_dataset import LMDBRecognitionDataset  # noqa: F401 (registers itself)
from .data.loader import Loader
from .experiment import Experiment
from .models.attention import AttentionRecognizer
from .models.detector import SegDetector
from .models.recognizer import CTCRecognizer
from .models.recognizer2d import Ctc2dRecognizer
from .models.spotter import RoITextSpotter, SharedTrunkSpotter
from .pipelines.bucketed import BucketedE2E
from .pipelines.e2e import E2EPipeline
from .pipelines.predictors import DetectorPredictor, RecognizerPredictor
from .pipelines.spotter_e2e import SpotterE2EPipeline
from .postproc.detection import SegDetectorRepresenter
from .postproc.measurers import DetectionMeasurer, DetEvalMeasurer, RecognitionMeasurer
from .postproc.visualizer import DetectionVisualizer
from .train.checkpoint import CheckpointManager
from .train.logger import Logger
from .train.train_step import OptimizerConfig
from .train.trainer import Trainer
from .utils.signal_monitor import SignalMonitor

PORTED = (
    Charset, AttentionCharset, SyntheticRecognitionDataset, SyntheticDetectionDataset,
    RecognitionListDataset, DetectionICDARDataset, MixtureDataset,
    HardSyntheticRecognitionDataset, HardSyntheticDetectionDataset, Loader, Experiment,
    CTCRecognizer, Ctc2dRecognizer, AttentionRecognizer, SegDetector, RoITextSpotter,
    SharedTrunkSpotter, E2EPipeline, BucketedE2E, SpotterE2EPipeline, RecognizerPredictor,
    DetectorPredictor, SegDetectorRepresenter, DetectionMeasurer, DetEvalMeasurer,
    RecognitionMeasurer, DetectionVisualizer, CheckpointManager, Logger, OptimizerConfig, Trainer,
    SignalMonitor,
)

for _cls in PORTED:
    COMPONENTS.register(_cls)
