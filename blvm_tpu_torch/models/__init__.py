from blvm_tpu_torch.models.wavenet import WaveNet

__all__ = ["WaveNet"]
