"""Model library: region encoder, brain encoder, BART decoder, assembled model."""

from .bart import BartDecoderModel, pseudo_encoder_sequence  # noqa: F401
from .brain_encoder import BrainRegionEncoder, feature_diversity_stats  # noqa: F401
from .eeg_model import EEGDecodingModel  # noqa: F401
from .folding import fold_batch_norm  # noqa: F401
from .hf_convert import convert_hf_bart_state_dict, resize_embedding  # noqa: F401
from .init import build_model, init_parameters  # noqa: F401
from .layers import MultiHeadAttention, RegionConvAttentionEncoder  # noqa: F401
