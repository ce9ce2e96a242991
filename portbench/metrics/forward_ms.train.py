"""forward_ms.train: the card's time a step in the train step's
``train.forward`` span (the program's spans, ``utils.profiling``): the
union of the device operations in the step's region of that part
(``_spans.train_parts_ms``), summed over the steps whose three spans lie
in the traced stretch, over those steps, in ms."""

from portbench.metrics._spans import train_parts_ms

UNIT = "ms"


def read(data: dict):
    parts = train_parts_ms(data)
    return None if parts is None else parts["train.forward"]
