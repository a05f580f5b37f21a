from repro_torch.core.optimizer.pipeline import CompileOptions, compile_program

__all__ = ["CompileOptions", "compile_program"]
