"""``TDMTrainer.sample`` (``train/sampler.py``): host clock around the
sampling of a step inside a ``train_resident`` call of the window's chunk,
a synchronize before and after, mean ms a step."""


def read(run):
    s = run["spans"].get("tdm_train.sample")
    return 1e3 * sum(s) / len(s) if s else None
