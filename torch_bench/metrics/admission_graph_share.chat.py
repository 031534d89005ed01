"""The share of the steady stretch's ``batcher.prefill`` spans that
replayed a captured admission chunk (their ``info.graph``), in %
(``torch_bench/admission.py``); silent where the spans do not say."""

from torch_bench import admission

read = admission.graph_share
