"""Stage-2 model: the student contrastive network, distilled from the
teacher.

Counterpart of ``c2matching_tpu/models/student_contras_distillation_
model.py``. ``net_student`` (from a generator seeded with
``manual_seed``, then ``path.pretrain_model_student``) runs on
(img_in_up, img_ref); ``net_teacher`` (from a generator seeded with 1, as
the JAX package draws ``PRNGKey(1)``, then ``path.pretrain_model_teacher``,
stage 1's ``net_g_*.pth``) runs frozen, in eval mode and without a graph,
on (img_in, img_ref). The loss is the student's triplet loss plus
``distill_weight`` times the KL of the temperature-scaled correlation rows
(``distillation_loss_batch``); only the student is in the optimizer, and
checkpoints are written under the label ``net_student``.
"""
import torch

from .contras_losses import distillation_loss_batch
from .networks import define_network
from .teacher_contras_model import ContrasModel


class StudentContrasDistillationModel(ContrasModel):

    net_label = 'net_student'
    net_names = ('net_student', 'net_teacher')
    batch_keys = ('img_in', 'img_in_up', 'img_ref', 'transformed_coordinate')
    val_labels = dict(ContrasModel.val_labels, distill_loss='distill_loss')

    def _build_nets(self, generator):
        self.net_student = define_network(self.opt['network_student'],
                                          generator)
        self.net_teacher = define_network(self.opt['network_teacher'],
                                          torch.Generator().manual_seed(1))
        self._load_path(self.net_student, 'pretrain_model_student')
        self._load_path(self.net_teacher, 'pretrain_model_teacher')
        self.net_student.to(self.device)
        self.net_teacher.to(self.device).eval().requires_grad_(False)
        self.print_network(self.net_student)
        self.print_network(self.net_teacher)
        self.trained = self.net_student

    def init_training_settings(self):
        super().init_training_settings()
        train_opt = self.opt['train']
        self.distill_weight = train_opt['distill_weight']
        self.temperature = train_opt['temperature']

    def _losses(self, **opts):
        with torch.no_grad():
            t_out = self.net_teacher(self.batch['img_in'],
                                     self.batch['img_ref'])
        s_out = self.net_student(self.batch['img_in_up'],
                                 self.batch['img_ref'])
        loss, pos, neg, distill, n_ok = distillation_loss_batch(
            s_out['dense_features1'], s_out['dense_features2'],
            t_out['dense_features1'], t_out['dense_features2'],
            self.batch['transformed_coordinate'],
            temperature=self.temperature, distill_weight=self.distill_weight,
            **{**self._loss_opts(), **opts})
        return {'loss': loss, 'pos_dist': pos, 'neg_dist': neg,
                'distill_loss': distill, 'n_valid': n_ok}
