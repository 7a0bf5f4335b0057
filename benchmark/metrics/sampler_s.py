"""sampler_s: synchronized seconds of the sampler stage (the DDPM loop
over the DiT) a request, from the benchmark's span around its call."""


def read(run):
    return getattr(run, "spans", {}).get("sampler")
