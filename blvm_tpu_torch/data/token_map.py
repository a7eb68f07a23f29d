"""Token <-> index mapping with the CTC blank at index 0 (copy of ``blvm_tpu/data/token_map.py``).

A sorted vocabulary with optional start, end, delimiter and unknown tokens; the
blank token, when added, is always index 0, as the CTC loss expects.
"""

from typing import Iterable, List, Optional

import numpy as np

from blvm_tpu_torch.data.tokens import BLANK_TOKEN, DELIMITER_TOKEN, END_TOKEN, START_TOKEN, UNKNOWN_TOKEN


class TokenMap:
    def __init__(
        self,
        tokens: List,
        add_start: bool = False,
        add_end: bool = False,
        add_delimit: bool = False,
        add_unknown: bool = False,
        add_blank: bool = False,
    ) -> None:
        assert not (add_delimit and (add_end or add_start)), "Cannot use start or end token with delimiter token."

        self.add_start = add_start
        self.add_end = add_end
        self.add_delimit = add_delimit
        self.add_unknown = add_unknown
        self.add_blank = add_blank
        self.prefix = ""
        self.suffix = ""

        tokens = sorted(list(tokens))

        if add_start:
            tokens.append(START_TOKEN)
            self.prefix = START_TOKEN
        if add_end:
            tokens.append(END_TOKEN)
            self.suffix = END_TOKEN
        if add_delimit:
            tokens.append(DELIMITER_TOKEN)
            self.prefix = DELIMITER_TOKEN
            self.suffix = DELIMITER_TOKEN
        if add_unknown:
            tokens.append(UNKNOWN_TOKEN)
        if add_blank:
            tokens.insert(0, BLANK_TOKEN)  # blank always index 0 for CTC

        self.tokens = tokens
        self.token2index = {t: i for i, t in enumerate(tokens)}
        self.index2token = {i: t for i, t in enumerate(tokens)}

    def get_index(self, token):
        if self.add_unknown:
            return self.token2index.get(token, self.token2index[UNKNOWN_TOKEN])
        return self.token2index[token]

    def get_token(self, index: int):
        return self.index2token[index]

    def encode(self, tokens: list) -> List[int]:
        tokens = list(self.prefix) + list(tokens) + list(self.suffix)
        return [self.get_index(t) for t in tokens]

    def decode(self, indices: Iterable[int], join_separator: Optional[str] = None):
        if hasattr(indices, "tolist"):  # numpy arrays and tensors
            indices = indices.tolist()
        if join_separator is None:
            return [self.index2token[i] for i in indices]
        return join_separator.join(self.index2token[i] for i in indices)

    def decode_batch(self, indices_batch, sl, join_separator: Optional[str] = None):
        if hasattr(indices_batch, "tolist"):
            indices_batch = np.asarray(indices_batch).tolist()
        assert len(indices_batch) == len(sl), "Batch must be first in `indices_batch`"
        return [self.decode(row[: int(n)], join_separator=join_separator) for row, n in zip(indices_batch, sl)]

    def __getitem__(self, idx: int):
        return self.get_token(idx)

    def __call__(self, token: str):
        return self.get_index(token)

    def __iter__(self):
        return iter(self.tokens)

    def __len__(self):
        return len(self.tokens)

    def __repr__(self):
        token_str = f"tokens={self.tokens}" if len(self.tokens) < 50 else f"|tokens|={len(self.tokens)}"
        return f"TokenMap({token_str})"
