"""String tokenizers (copy of ``blvm_tpu/data/tokenizers.py``)."""


def word_tokenizer(text: str) -> list:
    """Split a string by whitespace into words."""
    return text.split()


def char_tokenizer(text: str) -> list:
    """Split a string into individual characters."""
    return list(text)
