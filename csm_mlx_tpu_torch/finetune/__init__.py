"""Fine-tuning (port of `csm_mlx_tpu/finetune/`): datasets, losses,
trainers (SFT/DPO/KTO), LoRA/DoRA and checkpoints."""

from csm_mlx_tpu_torch.finetune.dataset import (
    CSMDataset,
    CSMPairwiseDataset,
    CSMPointwiseDataset,
)
from csm_mlx_tpu_torch.finetune.lora import linear_to_lora_layers, load_adapters
from csm_mlx_tpu_torch.finetune.trainer import (
    CSMTrainer,
    DPOArgs,
    DPOTrainer,
    KTOArgs,
    KTOTrainer,
    TrainArgs,
)

__all__ = [
    "CSMDataset",
    "CSMPairwiseDataset",
    "CSMPointwiseDataset",
    "CSMTrainer",
    "DPOTrainer",
    "KTOTrainer",
    "TrainArgs",
    "DPOArgs",
    "KTOArgs",
    "linear_to_lora_layers",
    "load_adapters",
]
