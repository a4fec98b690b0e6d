from repro_torch.train.elastic import ElasticController
from repro_torch.train.engine import BACKENDS, StepEngine, TrainerState
from repro_torch.train.serve import LMServer
from repro_torch.train.trainer import CodedTrainer

__all__ = [
    "BACKENDS",
    "CodedTrainer",
    "ElasticController",
    "LMServer",
    "StepEngine",
    "TrainerState",
]
