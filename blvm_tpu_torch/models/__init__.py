from blvm_tpu_torch.models.clockwork_vae.clockwork_vae import CWVAEAudio
from blvm_tpu_torch.models.lstm import LSTMAudio
from blvm_tpu_torch.models.lstm_asr import SimpleLSTMASR
from blvm_tpu_torch.models.srnn import SRNNAudio
from blvm_tpu_torch.models.stcn import STCN
from blvm_tpu_torch.models.vrnn import VRNNAudio
from blvm_tpu_torch.models.wavenet import WaveNet

__all__ = ["CWVAEAudio", "LSTMAudio", "SimpleLSTMASR", "SRNNAudio", "STCN", "VRNNAudio", "WaveNet"]
