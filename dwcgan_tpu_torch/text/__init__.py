from dwcgan_tpu_torch.text.vocab import Vocab, PAD, BOS, EOS, UNK, encode_commands, tokens_to_ids  # noqa: F401
from dwcgan_tpu_torch.text.synthesis import TextSynthesizer, CELEBA_ATTRS  # noqa: F401
