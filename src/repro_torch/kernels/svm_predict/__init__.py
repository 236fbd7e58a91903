from repro_torch.kernels.svm_predict.ops import svm_predict, svm_predict_cells

__all__ = ["svm_predict", "svm_predict_cells"]
