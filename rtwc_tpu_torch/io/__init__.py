from rtwc_tpu_torch.io.input import InputHandler, InputState
from rtwc_tpu_torch.io.presenter import ConsolePresenter
from rtwc_tpu_torch.io.sink import FramebufferSink

__all__ = ["ConsolePresenter", "FramebufferSink", "InputHandler", "InputState"]
