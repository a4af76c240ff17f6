"""``anyseq_tpu_torch.align`` on one pair: a constructed alignment (above
2^22 cells the linear-memory Hirschberg construction)."""
KIND = "alignment"


def call(program, item, mode, scoring, device):
    return [program.align(item.queries[0], item.subjects[0], mode, scoring,
                          device=device)]
