"""The paper's own Reference Layer (Sec. 4): 32x16x16 ifmaps ->
64x16x16 ofmaps, 3x3 filters, im2col size 288 (counterpart of
``repro.configs.refconv``). Used by the Reference-Layer examples
(``repro_torch.examples``) and ``chip_smoke.py``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RefConvConfig:
    name: str = "refconv"
    H: int = 16
    W: int = 16
    C_in: int = 32
    C_out: int = 64
    ksize: int = 3

    @property
    def im2col_size(self) -> int:
        return self.ksize * self.ksize * self.C_in  # 288, as in the paper


ARCH = RefConvConfig()
