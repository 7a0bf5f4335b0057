"""train_audio_s_per_s: seconds of training audio the steps of the window
consumed, over the window's wall seconds."""


def read(run):
    return run.window["audio_s"] / run.window["wall_s"]
