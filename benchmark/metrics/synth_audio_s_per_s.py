"""synth_audio_s_per_s: seconds of audio the requests of the window
returned, over the window's wall seconds."""


def read(run):
    return run.window["audio_s"] / run.window["wall_s"]
