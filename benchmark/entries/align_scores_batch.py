"""``anyseq_tpu_torch.align_scores_batch`` on a batch of pairs: one
optimal score a pair, in input order."""
KIND = "score"


def call(program, item, mode, scoring, device):
    return program.align_scores_batch(item.queries, item.subjects, mode,
                                      scoring, device=device)
