"""Evaluation (counterpart of kosmosx_tpu/eval/): token-weighted perplexity
over packed token batches, and text-overlap metrics."""

from kosmosx_torch.eval.perplexity import evaluate_perplexity, make_eval_step
from kosmosx_torch.eval.text_metrics import (bleu, exact_match, rouge_l,
                                             token_f1)

__all__ = ["evaluate_perplexity", "make_eval_step", "bleu", "rouge_l",
           "token_f1", "exact_match"]
