"""vocoder_s: synchronized seconds of the vocoder stage (BigVGAN) a
request, from the benchmark's span around its call."""


def read(run):
    return getattr(run, "spans", {}).get("vocoder")
