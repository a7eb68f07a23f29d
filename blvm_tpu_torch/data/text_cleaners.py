"""Text cleaners (copy of ``blvm_tpu/data/text_cleaners.py``)."""


def clean_timit(txt: str) -> str:
    """Clean TIMIT transcript text (works for .txt, .wrd and .phn files):
    strip per-line alignment prefixes, lowercase, normalize rare punctuation."""
    lines = txt.split("\n")
    if lines and not lines[-1]:
        lines = lines[:-1]

    # each line starts with "start_sample end_sample text..."
    lines = [" ".join(line.split()[2:]) for line in lines]
    txt = " ".join(lines)

    txt = txt.lower()
    txt = txt.replace(";", ",")
    txt = txt.replace(":", ".")
    txt = txt.replace('"', " ")
    return txt
