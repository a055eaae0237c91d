from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.data.dataset import lm_batches, synthetic_batches, text_to_ids

__all__ = ["ByteTokenizer", "lm_batches", "synthetic_batches", "text_to_ids"]
