"""``anyseq_tpu_torch.align_score`` on one pair: the optimal score."""
KIND = "score"


def call(program, item, mode, scoring, device):
    return [program.align_score(item.queries[0], item.subjects[0], mode,
                                scoring, device=device)]
