"""``anyseq_tpu_torch.align_batch`` on a batch of pairs: one constructed
alignment a pair, in input order."""
KIND = "alignment"


def call(program, item, mode, scoring, device):
    return program.align_batch(item.queries, item.subjects, mode, scoring,
                               device=device)
